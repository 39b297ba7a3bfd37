"""Replicated metadata KV: raft-lite consensus over the meta plane.

Reference behavior: the meta-srv delegates durability + HA to an etcd
cluster (src/meta-srv/src/service/store/etcd.rs:762, election at
src/meta-srv/src/election/etcd.rs:34-70). This repo's single-node stand-in
is FileKv; this module closes the gap for multi-meta deployments: N meta
nodes replicate a command log with term-voted leader election and
majority commit, so the cluster brain survives a node loss the way the
datanode plane already does (region failover, meta/service.py:259).

Design (raft essentials, sized to the meta workload):
- Every mutation is a command appended to the leader's log, replicated
  via append_entries, committed once a majority holds it, then applied
  to the state machine (a plain dict) — on every node, in log order.
- Elections: followers time out, become candidates, request votes; a
  vote needs the candidate's log to be at least as up-to-date
  (last_term, last_index) — the raft safety rule that keeps committed
  entries on whoever wins.
- Persistence: (term, voted_for, log) go to an atomic JSON snapshot per
  node before any RPC reply, so a restarted node rejoins with its word
  kept. State is rebuilt by replay.
- Transport is pluggable: in-process handles for tests/single-process
  clusters, Flight actions (meta/flight.py) across real sockets.

The KV surface (`ReplicatedKv`) matches MemKv, so MetaSrv mounts it
unchanged; non-leader nodes raise NotLeaderError carrying the leader
hint for client-side retry.

Ported from greptimedb_tpu/meta/replication.py (a copy): the persisted
JSON (`<store>.raft` and its `.snap`) and the raft RPC bodies are the
reference's, so nodes of either package form one cluster.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..common.telemetry import increment_counter
from ..errors import GreptimeError

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"
#: a follower's election timeout, seconds: drawn uniformly from this range
ELECTION_TIMEOUT = (1.5, 3.0)


class NotLeaderError(GreptimeError):
    def __init__(self, leader_id: Optional[int]) -> None:
        super().__init__(f"not the meta leader (leader hint: {leader_id})")
        self.leader_id = leader_id


class ProposeUncertainError(GreptimeError):
    """Commit could not be confirmed before the deadline. The entry may
    still commit later; retrying a non-idempotent op can double-apply."""

    def __init__(self) -> None:
        super().__init__("meta propose result unknown (no quorum ack "
                         "within the deadline); retry only idempotent ops")


class RaftNode:
    """One meta replica: consensus state + the applied KV dict."""

    def __init__(self, node_id: int, peer_ids: List[int],
                 *, store_path: Optional[str] = None,
                 election_timeout: Tuple[float, float] = ELECTION_TIMEOUT,
                 heartbeat_interval: float = 0.5,
                 compact_threshold: int = 256) -> None:
        self.node_id = node_id
        self.peer_ids = [p for p in peer_ids if p != node_id]
        self.transports: Dict[int, Any] = {}   # peer id -> transport
        self.store_path = store_path
        self._el_lo, self._el_hi = election_timeout
        self._hb_every = heartbeat_interval
        #: compact once the applied log tail exceeds this many entries —
        #: bounds both memory and the bytes rewritten per append (etcd
        #: compacts its revision history the same way,
        #: src/meta-srv/src/service/store/etcd.rs)
        self.compact_threshold = compact_threshold

        self._lock = threading.RLock()
        self._applied = threading.Condition(self._lock)
        # persistent
        self.term = 0
        self.voted_for: Optional[int] = None
        #: log[k] holds GLOBAL index base + k + 1; entries at or below
        #: `base` live only in the snapshot (state-at-base)
        self.log: List[dict] = []              # {term, op}
        self.base = 0                          # last compacted global idx
        self.snapshot_term = 0                 # term of the entry at base
        # volatile
        self.role = FOLLOWER
        self.leader_id: Optional[int] = None
        self.commit_idx = 0                    # global committed index
        self.applied_idx = 0
        self.state: Dict[str, bytes] = {}
        self.next_idx: Dict[int, int] = {}
        self._last_heard = time.monotonic()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        if store_path and os.path.exists(store_path):
            self._load()

    # ---- lifecycle ----
    def start(self) -> None:
        from ..common.runtime import new_thread
        self._stop.clear()
        t = new_thread(self._ticker, daemon=True,
                       name=f"raft-{self.node_id}",
                       propagate_context=False)
        t.start()
        self._threads = [t]

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
        with self._lock:
            # a stopped node serves nothing: drop leadership so stale
            # reads/writes fail over instead of answering from a corpse
            self.role = FOLLOWER
            self.leader_id = None

    # ---- global-index helpers (caller holds the lock) ----
    def _last_index(self) -> int:
        return self.base + len(self.log)

    def _term_at(self, gidx: int) -> int:
        if gidx <= self.base:
            return self.snapshot_term if gidx == self.base else 0
        return self.log[gidx - self.base - 1]["term"]

    # ---- persistence ----
    def _write_json(self, path: str, doc: dict) -> None:
        # no fsync: this persists on EVERY log append and the raft quorum
        # (not the disk) is the durability story — the atomic rename alone
        # guarantees a reader never sees a half-written doc
        from ..utils import atomic_write
        atomic_write(path, json.dumps(doc), fsync=False,
                     tmp_prefix=".raft-")

    def _persist_locked(self) -> None:
        """Persist term/vote and the (compaction-bounded) log tail. The
        snapshot file carries everything at or below `base`, so each
        append rewrites at most compact_threshold entries — not the
        whole history."""
        if not self.store_path:
            return
        self._write_json(self.store_path, {
            "term": self.term, "voted_for": self.voted_for,
            "base": self.base, "snapshot_term": self.snapshot_term,
            "enc": "latin-1", "log": self.log})

    def _persist_snapshot_locked(self) -> None:
        if not self.store_path:
            return
        self._write_json(self.store_path + ".snap", {
            "base": self.base, "snapshot_term": self.snapshot_term,
            "state": {k: v.decode("latin-1")
                      for k, v in self.state.items()}})

    def _load(self) -> None:
        snap_path = self.store_path + ".snap"
        if os.path.exists(snap_path):
            with open(snap_path) as f:
                snap = json.load(f)
            self.base = snap["base"]
            self.snapshot_term = snap.get("snapshot_term", 0)
            self.state = {k: v.encode("latin-1")
                          for k, v in snap["state"].items()}
            self.commit_idx = self.applied_idx = self.base
        with open(self.store_path) as f:
            doc = json.load(f)
        self.term = doc["term"]
        self.voted_for = doc.get("voted_for")
        log = doc["log"]
        if doc.get("enc") != "latin-1":
            # pre-compaction logs stored values utf-8-decoded; re-bridge
            # them to the latin-1 byte-preserving representation so
            # replay applies identical bytes
            log = [self._upgrade_entry(e) for e in log]
        log_base = doc.get("base", 0)
        if log_base < self.base:
            # snapshot advanced past the log file (crash between the two
            # writes — snap is always written first): drop the overlap
            drop = self.base - log_base
            log = log[drop:] if drop < len(log) else []
        elif log_base > self.base:
            # the log references compacted entries and no snapshot covers
            # them: refusing loudly beats silently serving an empty state
            # (and install-snapshotting that emptiness onto followers)
            raise GreptimeError(
                f"raft store {self.store_path!r} has log base {log_base} "
                f"but no snapshot at or beyond it ({self.base}); refusing "
                f"to start from a truncated history")
        self.log = log

    @staticmethod
    def _upgrade_entry(entry: dict) -> dict:
        """Re-encode a legacy (utf-8-bridged) log entry's value strings
        into the latin-1 byte-preserving representation."""
        def bridge(s: object) -> object:
            return s.encode("utf-8").decode("latin-1") \
                if isinstance(s, str) else s

        op = dict(entry.get("op") or {})
        for k in ("value", "expect"):
            if op.get(k) is not None:
                op[k] = bridge(op[k])
        if op.get("guard"):
            g = dict(op["guard"])
            if g.get("expect") is not None:
                g["expect"] = bridge(g["expect"])
            op["guard"] = g
        if op.get("ops"):
            op["ops"] = [(sub, k, bridge(v)) for sub, k, v in op["ops"]]
        out = dict(entry)
        out["op"] = op
        return out

    # ---- timers ----
    def _election_deadline(self) -> float:
        return self._last_heard + random.uniform(self._el_lo, self._el_hi)

    def _ticker(self) -> None:
        while not self._stop.is_set():
            time.sleep(self._hb_every / 2)
            with self._lock:
                role = self.role
                expired = time.monotonic() > self._election_deadline()
            if role == LEADER:
                self._broadcast_heartbeat()
            elif expired:
                self._run_election()

    # ---- election ----
    def _run_election(self) -> None:
        with self._lock:
            self.role = CANDIDATE
            self.term += 1
            self.voted_for = self.node_id
            self.leader_id = None
            self._last_heard = time.monotonic()
            term = self.term
            last_idx = self._last_index()
            last_term = self._term_at(last_idx)
            self._persist_locked()
        votes = 1
        for pid in self.peer_ids:
            tr = self.transports.get(pid)
            if tr is None:
                continue
            try:
                resp = tr.request_vote(term=term, candidate=self.node_id,
                                       last_idx=last_idx,
                                       last_term=last_term)
            except Exception:  # noqa: BLE001 — unreachable peer ≠ lost
                # election; the quorum math below absorbs it
                increment_counter("raft_rpc_errors")
                continue
            with self._lock:
                if resp["term"] > self.term:
                    self._step_down(resp["term"])
                    return
            if resp.get("granted"):
                votes += 1
        quorum = (len(self.peer_ids) + 1) // 2 + 1
        with self._lock:
            if self.role != CANDIDATE or self.term != term:
                return
            if votes >= quorum:
                self.role = LEADER
                self.leader_id = self.node_id
                self.next_idx = {p: self._last_index()
                                 for p in self.peer_ids}
                # a no-op in the new term lets prior-term entries commit
                # (raft §5.4.2: only current-term entries count quorum)
                self.log.append({"term": self.term, "op": {"kind": "noop"}})
                self._persist_locked()
        if self.role == LEADER:
            self._broadcast_heartbeat()

    def _step_down(self, term: int) -> None:
        # caller holds the lock
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._persist_locked()
        self.role = FOLLOWER
        self._last_heard = time.monotonic()

    # ---- RPC handlers (called by peers' transports) ----
    def handle_request_vote(self, term: int, candidate: int, last_idx: int,
                            last_term: int) -> dict:
        with self._lock:
            if term > self.term:
                self._step_down(term)
            granted = False
            if term == self.term and self.voted_for in (None, candidate):
                my_last = self._last_index()
                my_last_term = self._term_at(my_last)
                up_to_date = (last_term, last_idx) >= (my_last_term,
                                                       my_last)
                if up_to_date:
                    granted = True
                    self.voted_for = candidate
                    self._last_heard = time.monotonic()
                    self._persist_locked()
            return {"term": self.term, "granted": granted}

    def handle_append_entries(self, term: int, leader: int, prev_idx: int,
                              prev_term: int, entries: List[dict],
                              commit_idx: int) -> dict:
        with self._lock:
            if term < self.term:
                return {"term": self.term, "ok": False}
            if term > self.term or self.role != FOLLOWER:
                self._step_down(term)
            self.leader_id = leader
            self._last_heard = time.monotonic()
            if prev_idx < self.base:
                # everything at or below base is committed + applied via
                # the snapshot: skip the already-covered prefix
                drop = self.base - prev_idx
                if drop >= len(entries):
                    return {"term": self.term, "ok": True}
                entries = entries[drop:]
                prev_idx = self.base
                prev_term = self.snapshot_term
            # log matching: the entry before the new ones must agree
            if prev_idx > self._last_index() or (
                    prev_idx > self.base and
                    self._term_at(prev_idx) != prev_term):
                return {"term": self.term, "ok": False,
                        "have": min(self._last_index(), prev_idx)}
            if entries:
                # truncate only from the first genuinely conflicting
                # entry (term mismatch): a delayed, shorter AppendEntries
                # must not erase newer entries a later RPC already
                # appended (raft §5.3 — committed suffixes survive)
                changed = False
                for i, ent in enumerate(entries):
                    k = prev_idx + i - self.base      # 0-based log slot
                    if k >= len(self.log):
                        self.log.extend(entries[i:])
                        changed = True
                        break
                    if self.log[k]["term"] != ent["term"]:
                        self.log = self.log[:k] + list(entries[i:])
                        changed = True
                        break
                if changed:
                    self._persist_locked()
            if commit_idx > self.commit_idx:
                self.commit_idx = min(commit_idx, self._last_index())
                self._apply_locked()
            return {"term": self.term, "ok": True}

    def handle_install_snapshot(self, term: int, leader: int, base: int,
                                snapshot_term: int,
                                state: Dict[str, str]) -> dict:
        """Replace this follower's prefix with the leader's applied
        snapshot — sent when the leader has compacted away the entries
        the follower still needs (raft §7 InstallSnapshot)."""
        with self._lock:
            if term < self.term:
                return {"term": self.term, "ok": False}
            if term > self.term or self.role != FOLLOWER:
                self._step_down(term)
            self.leader_id = leader
            self._last_heard = time.monotonic()
            if base <= self.applied_idx:
                return {"term": self.term, "ok": True}
            # keep a log tail that extends beyond the snapshot only when
            # it provably continues it (the entry AT base must carry the
            # snapshot's term); otherwise it is an uncommitted branch
            keep = base - self.base
            if keep < len(self.log) and \
                    self.log[keep - 1]["term"] == snapshot_term:
                self.log = self.log[keep:]
            else:
                self.log = []
            self.state = {k: v.encode("latin-1") for k, v in state.items()}
            self.base = base
            self.snapshot_term = snapshot_term
            self.applied_idx = base
            self.commit_idx = max(self.commit_idx, base)
            self._persist_snapshot_locked()
            self._persist_locked()
            self._applied.notify_all()
            return {"term": self.term, "ok": True}

    # ---- replication ----
    def _broadcast_heartbeat(self) -> None:
        self._replicate()

    def _replicate(self) -> bool:
        """Push log tails to every follower; recompute commit_idx.
        Returns True when a majority matches the leader's log."""
        with self._lock:
            if self.role != LEADER:
                return False
            term = self.term
            total = self._last_index()
        acked = 1
        for pid in self.peer_ids:
            tr = self.transports.get(pid)
            if tr is None:
                continue
            for _ in range(8):   # walk next_idx back on mismatch
                with self._lock:
                    if self.role != LEADER or self.term != term:
                        return False
                    nxt = self.next_idx.get(pid, total)
                    snap = None
                    if nxt < self.base:
                        # the tail this follower needs is compacted away:
                        # ship the applied snapshot instead, then resume
                        # normal appends from its index
                        snap = (self.applied_idx,
                                self._term_at(self.applied_idx),
                                {k: v.decode("latin-1")
                                 for k, v in self.state.items()})
                    else:
                        prev_idx = nxt
                        prev_term = self._term_at(nxt)
                        entries = self.log[nxt - self.base:
                                           total - self.base]
                        commit = self.commit_idx
                try:
                    if snap is not None:
                        resp = tr.install_snapshot(
                            term=term, leader=self.node_id, base=snap[0],
                            snapshot_term=snap[1], state=snap[2])
                    else:
                        resp = tr.append_entries(
                            term=term, leader=self.node_id,
                            prev_idx=prev_idx, prev_term=prev_term,
                            entries=entries, commit_idx=commit)
                except Exception:  # noqa: BLE001 — follower unreachable:
                    # end this round, the next tick retries from next_idx
                    increment_counter("raft_rpc_errors")
                    break
                with self._lock:
                    if resp["term"] > self.term:
                        self._step_down(resp["term"])
                        return False
                    if snap is not None:
                        if resp.get("ok"):
                            self.next_idx[pid] = snap[0]
                            continue   # follow with the remaining tail
                        break
                    if resp.get("ok"):
                        self.next_idx[pid] = total
                        acked += 1
                        break
                    self.next_idx[pid] = min(
                        resp.get("have", max(nxt - 1, 0)), total)
        quorum = (len(self.peer_ids) + 1) // 2 + 1
        with self._lock:
            if self.role != LEADER or self.term != term:
                return False
            # only an index whose entry is from the current term may
            # advance the commit point (raft §5.4.2); the election no-op
            # guarantees such an entry exists promptly
            if acked >= quorum and total > self.commit_idx \
                    and total > self.base \
                    and self._term_at(total) == self.term:
                self.commit_idx = total
                self._apply_locked()
            return acked >= quorum

    # ---- state machine ----
    def _apply_locked(self) -> None:
        while self.applied_idx < self.commit_idx:
            entry = self.log[self.applied_idx - self.base]
            entry["result"] = self._apply_op(entry["op"])
            self.applied_idx += 1
        self._applied.notify_all()
        if len(self.log) > self.compact_threshold \
                and self.applied_idx > self.base:
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Fold the applied log prefix into the snapshot: state is
        already AT applied_idx, so compaction is a copy-free truncation
        plus one snapshot write. Bounds memory and per-append persist
        cost; lagging followers past the horizon get InstallSnapshot."""
        cut = self.applied_idx - self.base
        self.snapshot_term = self.log[cut - 1]["term"]
        self.log = self.log[cut:]
        self.base = self.applied_idx
        self._persist_snapshot_locked()
        self._persist_locked()

    def _apply_op(self, op: dict) -> object:
        kind = op["kind"]
        key = op.get("key")
        if kind == "put":
            self.state[key] = op["value"].encode("latin-1")
            return True
        if kind == "delete":
            return self.state.pop(key, None) is not None
        if kind == "cap":                      # compare_and_put
            expect = op["expect"].encode("latin-1") \
                if op["expect"] is not None else None
            if self.state.get(key) != expect:
                return False
            self.state[key] = op["value"].encode("latin-1")
            return True
        if kind == "cad":                      # compare_and_delete
            if self.state.get(key) != op["expect"].encode("latin-1"):
                return False
            del self.state[key]
            return True
        if kind == "incr":
            cur = int(self.state.get(key, str(op["start"]).encode()))
            nxt = cur + 1
            self.state[key] = str(nxt).encode()
            return nxt
        if kind == "batch":
            guard = op.get("guard")
            if guard is not None:
                expect = guard["expect"].encode("latin-1") \
                    if guard["expect"] is not None else None
                if self.state.get(guard["key"]) != expect:
                    return False
            for sub, k, v in op["ops"]:
                if sub == "put":
                    self.state[k] = v.encode("latin-1")
                elif sub == "delete":
                    self.state.pop(k, None)
                else:
                    # mirrors MemKv._apply_batch_locked; ReplicatedKv.batch
                    # validates at propose time so this can't enter the log
                    raise GreptimeError(f"unknown batch sub-op {sub!r}")
            return True
        if kind == "noop":
            return None
        raise GreptimeError(f"unknown raft op {kind!r}")

    # ---- client entry ----
    def propose(self, op: dict, timeout: float = 10.0) -> object:
        """Append on the leader, replicate to a majority, apply, return
        the op result. Raises NotLeaderError elsewhere, and
        ProposeUncertainError when commit cannot be confirmed in time —
        the entry may still commit later, so blind retries of
        non-idempotent ops (CAS, incr) are not safe on that error."""
        with self._lock:
            if self.role != LEADER:
                raise NotLeaderError(self.leader_id)
            entry = {"term": self.term, "op": op}
            self.log.append(entry)
            idx = self._last_index()
            self._persist_locked()
        self._replicate()   # best effort; heartbeats keep pushing
        with self._lock:
            deadline = time.monotonic() + timeout
            while True:
                if self.applied_idx >= idx:
                    # the entry object survives compaction, so its result
                    # is readable even after the log slot is truncated
                    return entry.get("result")
                lost = idx > self._last_index() or (
                    idx > self.base and
                    self.log[idx - self.base - 1] is not entry)
                if lost:
                    # a new leader overwrote the uncommitted entry
                    raise NotLeaderError(self.leader_id
                                         if self.leader_id != self.node_id
                                         else None)
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._applied.wait(
                        timeout=min(remaining, self._hb_every)):
                    if time.monotonic() >= deadline:
                        raise ProposeUncertainError()

    def read_state(self) -> Dict[str, bytes]:
        with self._lock:
            if self.role != LEADER:
                raise NotLeaderError(self.leader_id)
            return dict(self.state)

    def get_value(self, key: str) -> Optional[bytes]:
        """Single-key leader read without copying the state dict."""
        with self._lock:
            if self.role != LEADER:
                raise NotLeaderError(self.leader_id)
            return self.state.get(key)

    def range_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        """Prefix scan on the leader, materializing only the matches."""
        with self._lock:
            if self.role != LEADER:
                raise NotLeaderError(self.leader_id)
            return sorted((k, v) for k, v in self.state.items()
                          if k.startswith(prefix))

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self.role == LEADER


class LocalTransport:
    """Direct in-process transport (the MemKv of transports)."""

    def __init__(self, node: RaftNode) -> None:
        self.node = node

    def request_vote(self, **kw: object) -> dict:
        return self.node.handle_request_vote(**kw)

    def append_entries(self, **kw: object) -> dict:
        return self.node.handle_append_entries(**kw)

    def install_snapshot(self, **kw: object) -> dict:
        return self.node.handle_install_snapshot(**kw)


def connect_local(nodes: List[RaftNode]) -> None:
    for a in nodes:
        for b in nodes:
            if a is not b:
                a.transports[b.node_id] = LocalTransport(b)


class FlightTransport:
    """Raft RPCs over the meta Flight plane (meta/flight.py actions
    raft_request_vote / raft_append_entries) for multi-process meta.

    Unlike the reference's transport, every call carries a deadline: half
    the lower end of the owning node's election timeout
    (`rpc_deadline`), and four times that for install_snapshot, which
    ships the whole applied state. The leader replicates to its peers
    one after another, so without one a call to a stuck peer holds the
    whole round, the other followers hear no heartbeat, and a new
    leader cannot commit its election no-op. A call that times out or
    finds the peer unreachable drops the cached client (the next call
    dials again) and raises: the round counts it in raft_rpc_errors and
    goes on to the next peer, and the next tick retries. The RPC bodies
    and answers are the reference's.

    A follower's refusal (`"ok": false` beside its term: a log mismatch
    with the `have` hint, or a stale term) is an answer, returned as
    LocalTransport returns it, so the leader walks `next_idx` back or
    steps down. The reference's transport raises on it, so over Flight
    its leader can never bring a lagging follower up to date; only a
    server error (its `error` key) raises here.

    `node` is the RaftNode that owns the transport; without one the
    deadline follows RaftNode's default election timeout."""

    def __init__(self, address: str, node: Optional[RaftNode] = None) -> None:
        self.address = address
        self.node = node
        self._client = None

    @property
    def rpc_deadline(self) -> float:
        lo = self.node._el_lo if self.node is not None \
            else ELECTION_TIMEOUT[0]
        return lo / 2

    def _action(self, kind: str, body: dict,
                deadline: Optional[float] = None) -> dict:
        import json as _json

        import pyarrow.flight as flight
        if self._client is None:
            self._client = flight.FlightClient(self.address)
        opts = flight.FlightCallOptions(
            timeout=self.rpc_deadline if deadline is None else deadline)
        try:
            results = list(self._client.do_action(
                flight.Action(kind, _json.dumps(body).encode()), opts))
        except (flight.FlightTimedOutError, flight.FlightUnavailableError):
            client, self._client = self._client, None
            client.close()
            raise
        resp = _json.loads(results[0].body.to_pybytes())
        if "error" in resp or "term" not in resp:
            raise GreptimeError(resp.get("error", "meta raft rpc failed"))
        return resp

    def request_vote(self, **kw: object) -> dict:
        return self._action("raft_request_vote", kw)

    def append_entries(self, **kw: object) -> dict:
        return self._action("raft_append_entries", kw)

    def install_snapshot(self, **kw: object) -> dict:
        return self._action("raft_install_snapshot", kw,
                            deadline=4 * self.rpc_deadline)


class HaMetaClient:
    """MetaClient facade over several replicated MetaSrv instances:
    every call retries across servers until it lands on the leader
    (reference clients iterate etcd endpoints the same way)."""

    def __init__(self, srvs: "List[object]", *, retry_delay: float = 0.15,
                 max_rounds: int = 40) -> None:
        from .service import MetaClient
        self.clients = [MetaClient(s) for s in srvs]
        self._cur = 0
        self._delay = retry_delay
        self._rounds = max_rounds

    def __getattr__(self, name: str) -> object:
        if name.startswith("_"):
            raise AttributeError(name)

        def call(*args: object, **kwargs: object) -> object:
            last: Optional[Exception] = None
            for _ in range(self._rounds):
                client = self.clients[self._cur % len(self.clients)]
                try:
                    return getattr(client, name)(*args, **kwargs)
                except NotLeaderError as e:
                    last = e
                    self._cur += 1
                    time.sleep(self._delay)
            raise last if last is not None else GreptimeError(
                "no meta leader reachable")
        return call


class ReplicatedKv:
    """MemKv-interface facade over a RaftNode, so MetaSrv mounts a
    replicated store exactly like MemKv/FileKv (meta/kv.py)."""

    def __init__(self, node: RaftNode) -> None:
        self.node = node

    # reads (leader-local, linearizable after majority-committed writes)
    def get(self, key: str) -> Optional[bytes]:
        return self.node.get_value(key)

    def range(self, prefix: str) -> List[Tuple[str, bytes]]:
        return self.node.range_prefix(prefix)

    # writes (consensus round-trips)
    def put(self, key: str, value: bytes) -> None:
        # latin-1 maps bytes<->str 1:1, so arbitrary (non-UTF-8) values
        # survive the JSON-encoded raft log — matching MemKv/FileKv
        self.node.propose({"kind": "put", "key": key,
                           "value": value.decode("latin-1")})

    def delete(self, key: str) -> bool:
        return bool(self.node.propose({"kind": "delete", "key": key}))

    def compare_and_put(self, key: str, expect: Optional[bytes],
                        value: bytes) -> bool:
        return bool(self.node.propose({
            "kind": "cap", "key": key,
            "expect": expect.decode("latin-1") if expect is not None
            else None,
            "value": value.decode("latin-1")}))

    def compare_and_delete(self, key: str, expect: bytes) -> bool:
        return bool(self.node.propose({
            "kind": "cad", "key": key,
            "expect": expect.decode("latin-1")}))

    def incr(self, key: str, start: int = 0) -> int:
        return int(self.node.propose({"kind": "incr", "key": key,
                                      "start": start}))

    def batch(self, ops: List[Tuple[str, str, Optional[bytes]]],
              guard: Optional[Tuple[str, Optional[bytes]]] = None
              ) -> bool:
        for op, k, v in ops:        # reject bad ops BEFORE they hit the log
            if op not in ("put", "delete"):
                raise ValueError(f"unknown batch op {op!r}")
            if op == "put" and not isinstance(v, bytes):
                raise ValueError(f"batch put needs bytes for {k!r}")
        g = None
        if guard is not None:
            g = {"key": guard[0],
                 "expect": guard[1].decode("latin-1")
                 if guard[1] is not None else None}
        return bool(self.node.propose({
            "kind": "batch", "guard": g,
            "ops": [(op, k, v.decode("latin-1") if v is not None
                     else None) for op, k, v in ops]}))
