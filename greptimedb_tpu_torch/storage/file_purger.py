"""Deleted-SST garbage collection.

Reference behavior: src/storage/src/file_purger.rs — files removed from a
region version by compaction are deleted asynchronously once no reader holds
them. Snapshots here are short-lived and the scan cache is version-keyed, so
a grace delay stands in for the reference's handle refcounting: a file
becomes eligible `grace_s` seconds after it left the version (0 = purge on
the next sweep).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Tuple

from ..common import failpoint as _fp
from ..common.locks import TrackedLock

logger = logging.getLogger(__name__)

_fp.register("purger_delete")

#: failed deletes re-queue with this backoff ladder, then drop (the
#: region open-time orphan sweep is the backstop for dropped files)
_RETRY_BACKOFF_S = (5.0, 30.0, 120.0)


class FilePurger:
    def __init__(self, grace_s: float = 60.0):
        self.grace_s = grace_s
        self._lock = TrackedLock("storage.purger", io_ok=False)
        # (due_time, delete_fn, name, attempt)
        self._pending: List[Tuple[float, Callable[[], None], str, int]] = []

    def schedule(self, delete_fn: Callable[[], None], name: str) -> None:
        with self._lock:
            self._pending.append(
                (time.time() + self.grace_s, delete_fn, name, 0))

    def sweep(self, force: bool = False) -> int:
        """Delete everything whose grace period has passed (force=True:
        everything pending — engine shutdown, when no reader can remain).
        A failed delete re-queues with backoff instead of leaking the
        file on the first transient object-store error; after the backoff
        ladder is exhausted it drops (the reopen orphan sweep catches it).
        Returns the number deleted."""
        now = time.time()
        with self._lock:
            due = [item for item in self._pending
                   if force or item[0] <= now]
            self._pending = [] if force else \
                [item for item in self._pending if item[0] > now]
        if due:
            from ..common import background_jobs
            ctx = background_jobs.job("purge", files=len(due))
        else:
            import contextlib
            ctx = contextlib.nullcontext()
        with ctx:
            deleted, requeue = self._delete_due(due, force, now)
        if requeue:
            from ..common.telemetry import increment_counter
            increment_counter("purge_retries", len(requeue))
            with self._lock:
                self._pending.extend(requeue)
        return deleted

    def _delete_due(self, due, force: bool, now: float):
        deleted = 0
        requeue = []
        for _, fn, name, attempt in due:
            try:
                _fp.fail_point("purger_delete")
                fn()
                deleted += 1
            except FileNotFoundError:
                deleted += 1
            except Exception as e:  # noqa: BLE001
                if force or attempt >= len(_RETRY_BACKOFF_S):
                    logger.exception(
                        "purging %s failed after %d attempts; dropping "
                        "(reopen orphan sweep will collect it)", name,
                        attempt + 1)
                else:
                    delay = _RETRY_BACKOFF_S[attempt]
                    logger.warning(
                        "purging %s failed (%s); retry %d/%d in %.0fs",
                        name, e, attempt + 1, len(_RETRY_BACKOFF_S), delay)
                    requeue.append((now + delay, fn, name, attempt + 1))
        return deleted, requeue

    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)
