"""Continuous WAL-tail replication: the leader datanode's ship loop.

Read replicas bootstrap through the balancer's op-doc
snapshot+tail codec (meta/balancer.py `replica_add`), then stay caught
up through this shipper: every committed write nudges it via the
region's `on_commit` hook, and a background thread reads the new WAL
records (`Region.wal_entries_since` — safe on a live region) and pushes
them to each follower's `repl_apply`. Acks NEVER wait on followers: the
hook only sets a dirty bit under a condition variable.

Delivery is at-least-once with self-healing gaps: a ship round only
advances the per-region cursor when every follower applied it, and a
follower that observes a sequence gap (or a leader flush that obsoleted
the segments it missed) reopens its standby region from the shared
manifest (`MitoEngine.refresh_standby`), which always covers anything
the WAL no longer holds — the WAL never deletes a segment above the
flushed sequence.

Follower targets arrive via `repl_set_followers` mailbox messages (the
balancer wires them after the route commit, and failover re-wires them
after a promotion); the target list itself is durable in the meta route
doc, so this in-memory state is reconstructible.

Ported whole from greptimedb_tpu/datanode/replication.py (host code only):
the `repl_apply` bodies it ships are the reference's, so a port leader
ships to a reference follower and the reverse.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from ..common import failpoint as _fp
from ..errors import RegionNotFoundError

logger = logging.getLogger(__name__)

_fp.register("repl_ship")

#: records per ship round — bounds one round's memory/wire cost; the
#: drain loop keeps going while a region stays behind
SHIP_BATCH_RECORDS = 4096


def _follower_id(follower: dict):
    """Peer docs spell the node id either way: the meta route's
    Peer.to_dict uses "id", mailbox bodies may carry "node_id"."""
    nid = follower.get("node_id", follower.get("id"))
    return int(nid) if nid is not None else None


class ReplicaShipper:
    """Per-datanode background shipper for all leader regions that have
    followers attached."""

    def __init__(self, datanode) -> None:
        self.datanode = datanode
        self._cond = threading.Condition()
        #: region_name -> {"catalog","schema","table","region_number",
        #:   "followers":[{"node_id","addr"}], "last_shipped": int}
        self._targets: Dict[str, dict] = {}
        self._dirty: set = set()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        #: (node_id, addr) -> client (Flight conns are reusable; the
        #: in-process registry resolves per call and is not cached here)
        self._clients: Dict[tuple, object] = {}

    # ---- wiring (repl_set_followers mailbox step) ----
    def set_followers(self, catalog: str, schema: str, table: str,
                      region_number: int, region_name: str,
                      followers: List[dict]) -> int:
        """Replace the follower set for one region; an empty set detaches
        it (and clears the region's on_commit hook)."""
        try:
            region = self.datanode.storage.get_region(region_name)
        except RegionNotFoundError:
            region = None
        with self._cond:
            if not followers:
                self._targets.pop(region_name, None)
                self._dirty.discard(region_name)
            else:
                prev = self._targets.get(region_name)
                # start the cursor at the flushed sequence: everything
                # below it is durable in shared SSTs (a freshly attached
                # follower adopted that state), everything above ships —
                # followers skip already-applied records idempotently
                last = prev["last_shipped"] if prev is not None else (
                    int(region.version_control.current.flushed_sequence)
                    if region is not None else 0)
                self._targets[region_name] = {
                    "catalog": catalog, "schema": schema, "table": table,
                    "region_number": int(region_number),
                    "followers": list(followers), "last_shipped": last}
                self._dirty.add(region_name)
                self._cond.notify()
        if region is not None:
            region.on_commit = self.notify if followers else None
        if followers:
            self._ensure_thread()
        logger.info("replica shipper: region %s now has %d follower(s)",
                    region_name, len(followers))
        return len(followers)

    def targets(self) -> Dict[str, dict]:
        with self._cond:
            return {k: dict(v) for k, v in self._targets.items()}

    # ---- leader write hook (Region.on_commit) ----
    def notify(self, region) -> None:
        with self._cond:
            if region.name in self._targets:
                self._dirty.add(region.name)
                self._cond.notify()

    # ---- the ship loop ----
    def _ensure_thread(self) -> None:
        with self._cond:
            if self._thread is not None and self._thread.is_alive():
                return
            from ..common.runtime import new_thread
            self._stop = False
            self._thread = new_thread(
                self._run, daemon=True,
                name=f"repl-ship-dn{self.datanode.opts.node_id}",
                propagate_context=False)
            self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cond:
                if not self._dirty and not self._stop:
                    # the timeout doubles as the retry tick: a region a
                    # failed round left behind re-ships without waiting
                    # for the next write
                    self._cond.wait(timeout=0.5)
                if self._stop:
                    return
                names = set(self._dirty)
                self._dirty.clear()
                names.update(self._lagging_locked())
            for name in sorted(names):
                try:
                    self.ship_region(name)
                except Exception:  # noqa: BLE001 — one region's ship
                    logger.exception(      # failure must not kill the loop
                        "replica ship for region %s failed", name)

    def _lagging_locked(self) -> List[str]:
        """Regions whose cursor trails their committed sequence (failed
        or truncated earlier rounds). Caller holds the condition."""
        out = []
        for name, t in self._targets.items():
            try:
                region = self.datanode.storage.get_region(name)
            except RegionNotFoundError:
                continue
            if t["last_shipped"] < region.version_control.committed_sequence:
                out.append(name)
        return out

    def ship_region(self, region_name: str) -> Optional[dict]:
        """One ship round for one region: read the WAL delta past the
        cursor and push it to every follower. Public so tests and the
        acceptance harness can drain synchronously. Returns the round's
        summary, or None when the region has no followers / is gone."""
        from ..common.telemetry import increment_counter
        with self._cond:
            target = self._targets.get(region_name)
        if target is None:
            return None
        try:
            region = self.datanode.storage.get_region(region_name)
        except RegionNotFoundError:
            with self._cond:
                self._targets.pop(region_name, None)
            return None
        last = target["last_shipped"]
        flushed = int(region.version_control.current.flushed_sequence)
        entries = region.wal_entries_since(
            last, max_records=SHIP_BATCH_RECORDS)
        if not entries and flushed <= last and \
                region.version_control.committed_sequence <= last:
            return {"shipped": 0, "followers_ok": len(target["followers"])}
        # crash/err HERE (torture): the cursor has not advanced, so the
        # round re-ships after restart — followers dedup by sequence
        _fp.fail_point("repl_ship")
        ok = 0
        for follower in target["followers"]:
            try:
                client = self._client_for(follower)
                if client is None:
                    raise RegionNotFoundError(
                        f"follower dn{_follower_id(follower)} "
                        f"unreachable (no address, not in-process)")
                client.repl_apply(
                    target["catalog"], target["schema"], target["table"],
                    target["region_number"], entries,
                    leader_flushed=flushed)
                ok += 1
            except Exception as e:  # noqa: BLE001 — a lagging/briefly-dead
                # follower self-heals by manifest refresh on a later round
                increment_counter("repl_ship_errors")
                logger.warning(
                    "replica ship %s -> dn%s failed (%s: %s); follower "
                    "will gap-refresh", region_name,
                    _follower_id(follower), type(e).__name__, e)
        advanced = False
        if ok == len(target["followers"]):
            # advance only on full success: a partial round re-ships to
            # everyone (idempotent) instead of leaving one follower with
            # a gap the WAL may later obsolete
            new_last = int(entries[-1]["seq"]) if entries \
                else max(last, flushed)
            with self._cond:
                cur = self._targets.get(region_name)
                if cur is not None and cur["last_shipped"] < new_last:
                    cur["last_shipped"] = new_last
                    advanced = True
                if cur is not None and entries and \
                        len(entries) >= SHIP_BATCH_RECORDS:
                    self._dirty.add(region_name)   # more behind: keep going
                    self._cond.notify()
        if entries and ok:
            increment_counter("repl_records_shipped", len(entries))
        return {"shipped": len(entries), "followers_ok": ok,
                "advanced": advanced}

    def drain(self, region_name: str, rounds: int = 64) -> None:
        """Ship until the region's cursor catches its committed sequence
        (tests / acceptance; production relies on the loop)."""
        for _ in range(rounds):
            with self._cond:
                target = self._targets.get(region_name)
            if target is None:
                return
            try:
                region = self.datanode.storage.get_region(region_name)
            except RegionNotFoundError:
                return
            if target["last_shipped"] >= \
                    region.version_control.committed_sequence:
                return
            self.ship_region(region_name)

    def _client_for(self, follower: dict):
        """Resolve a follower to a datanode client: a live in-process
        instance first (single-process clusters), then Arrow Flight by
        the peer's advertised address."""
        node_id = _follower_id(follower)
        from .instance import live_datanode
        inst = live_datanode(node_id)
        if inst is not None:
            return inst
        addr = follower.get("addr") or ""
        if not addr:
            return None
        key = (node_id, addr)
        client = self._clients.get(key)
        if client is None:
            from ..client.flight import FlightDatanodeClient
            location = addr if "://" in addr else f"grpc://{addr}"
            client = FlightDatanodeClient(location, int(node_id))
            self._clients[key] = client
        return client

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
        for client in self._clients.values():
            try:
                client.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                logger.debug("replica shipper: client close failed",
                             exc_info=True)
        self._clients.clear()
