"""Distributed lock + leader election over the meta KV.

Reference behavior: src/meta-srv/src/lock/ — an etcd-backed distributed
lock keyed by name, and src/meta-srv/src/election/etcd.rs:34-70 — leader
election via a leased key so exactly one metasrv drives failover/routing
at a time. Both reduce to the same KV primitive available here:
compare-and-put of (holder, expiry) with lease renewal.

Ported from greptimedb_tpu/meta/lock.py (a copy).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Optional

from .kv import MemKv

LOCK_PREFIX = "__meta/lock/"
ELECTION_KEY = "__meta/election/leader"


class DistributedLock:
    """Lease-based mutual exclusion over the shared KV."""

    def __init__(self, kv: MemKv, name: str, *, lease_secs: float = 10.0,
                 holder: Optional[str] = None) -> None:
        self.kv = kv
        self.key = f"{LOCK_PREFIX}{name}"
        self.lease_secs = lease_secs
        self.holder = holder or uuid.uuid4().hex

    def _doc(self, now: float) -> bytes:
        return json.dumps({"holder": self.holder,
                           "expires": now + self.lease_secs}).encode()

    def try_acquire(self, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        current = self.kv.get(self.key)
        if current is None:
            return self.kv.compare_and_put(self.key, None, self._doc(now))
        doc = json.loads(current)
        if doc["holder"] == self.holder or doc["expires"] < now:
            # re-entrant renewal or expired lease takeover
            return self.kv.compare_and_put(self.key, current,
                                           self._doc(now))
        return False

    def acquire(self, timeout: float = 30.0,
                poll_interval: float = 0.05) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.try_acquire():
                return True
            time.sleep(poll_interval)
        return False

    def renew(self, now: Optional[float] = None) -> bool:
        return self.try_acquire(now)

    def release(self) -> bool:
        current = self.kv.get(self.key)
        if current is None:
            return False
        if json.loads(current)["holder"] != self.holder:
            return False
        # atomic: a plain get/delete could remove a lock another node
        # acquired after our lease expired between the get and the delete
        return self.kv.compare_and_delete(self.key, current)

    def holder_of(self, now: Optional[float] = None) -> Optional[str]:
        now = time.time() if now is None else now
        current = self.kv.get(self.key)
        if current is None:
            return None
        doc = json.loads(current)
        return doc["holder"] if doc["expires"] >= now else None

    def __enter__(self) -> "DistributedLock":
        if not self.acquire():
            raise TimeoutError(f"could not acquire lock {self.key}")
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()


class Election:
    """Leader election: a named lease the winner keeps renewing
    (reference: etcd election, election/etcd.rs). Only the leader runs
    failover checks / route mutations when several metasrv replicas
    share one KV."""

    def __init__(self, kv: MemKv, candidate_id: str,
                 *, lease_secs: float = 10.0,
                 renew_interval: float = 3.0) -> None:
        self._lock = DistributedLock(kv, "__leader__",
                                     lease_secs=lease_secs,
                                     holder=candidate_id)
        self.candidate_id = candidate_id
        self.renew_interval = renew_interval
        self._task = None

    def campaign_once(self, now: Optional[float] = None) -> bool:
        from ..common.telemetry import root_span
        with root_span("election_campaign", candidate=self.candidate_id):
            return self._lock.try_acquire(now)

    @property
    def is_leader(self) -> bool:
        return self._lock.holder_of() == self.candidate_id

    def leader(self) -> Optional[str]:
        return self._lock.holder_of()

    def start(self) -> None:
        """Background campaign + renewal loop."""
        from ..storage.scheduler import RepeatedTask
        if self._task is None:
            self.campaign_once()
            self._task = RepeatedTask(self.renew_interval,
                                      self.campaign_once,
                                      name=f"election-{self.candidate_id}")
            self._task.start()

    def stop(self) -> None:
        if self._task is not None:
            self._task.stop()
            self._task = None
        if self.is_leader:
            self._lock.release()
