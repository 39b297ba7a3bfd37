"""Background job scheduler with request dedup and inflight limits.

Reference behavior: src/storage/src/scheduler.rs — `LocalScheduler` drains a
`DedupDeque` (re-submitting a queued key is a no-op) through a
`MaxInflightTaskLimiter`; jobs run on a small worker pool shared by flush
and compaction. Here the pool is a plain thread pool: these jobs are
host-side IO (Parquet encode, manifest writes) and kernel launches, so
Python threads overlap fine.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict

from ..common.locks import TrackedLock
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)


class JobHandle:
    """Completion handle for a scheduled job."""

    def __init__(self):
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._result = None

    def wait(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("job did not complete in time")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def _finish(self, result=None, error: Optional[BaseException] = None):
        self._result = result
        self._error = error
        self._done.set()


class LocalScheduler:
    """Deduplicating background scheduler.

    - `submit(key, fn)`: runs fn on a worker thread. While a job with the
      same key is *queued*, further submits coalesce into it (both callers
      get the same handle). A job whose key is currently *running* queues
      one follow-up run (the reference's DedupDeque semantics).
    - at most `max_inflight` jobs run concurrently; the queue is unbounded.
    """

    def __init__(self, max_inflight: int = 4, name: str = "bg"):
        self.max_inflight = max(1, max_inflight)
        self.name = name
        self._lock = TrackedLock("storage.scheduler", io_ok=False)
        from ..common.tracking import tracked_state
        self._queue: "OrderedDict[str, tuple]" = tracked_state(
            OrderedDict(), "storage.scheduler.queue")
        self._running: Dict[str, bool] = tracked_state(
            {}, "storage.scheduler.running")
        self._workers: list = []
        self._wake = threading.Condition(self._lock)
        self._stopped = False
        for i in range(self.max_inflight):
            t = threading.Thread(target=self._worker_loop,
                                 name=f"{name}-worker-{i}", daemon=True)
            t.start()
            self._workers.append(t)

    def submit(self, key: str, fn: Callable[[], object]) -> JobHandle:
        with self._lock:
            if self._stopped:
                from ..errors import SchedulerStoppedError
                raise SchedulerStoppedError(
                    f"scheduler {self.name} stopped")
            if key in self._queue:
                return self._queue[key][1]        # coalesce
            handle = JobHandle()
            self._queue[key] = (fn, handle)
            self._wake.notify()
            return handle

    def submit_later(self, key: str, fn: Callable[[], object],
                     delay_s: float) -> None:
        """Queue `fn` under `key` after a delay — the retry-with-backoff
        hook for failed background jobs. Fire-and-forget: if the
        scheduler stops before the timer fires, the submit is dropped
        (shutdown must not resurrect work)."""
        def fire():
            try:
                self.submit(key, fn)
            except RuntimeError:
                pass                      # scheduler stopped meanwhile
        t = threading.Timer(delay_s, fire)
        t.daemon = True
        t.start()

    def _worker_loop(self):
        while True:
            with self._lock:
                while True:
                    key = next((k for k in self._queue
                                if k not in self._running), None)
                    if key is not None:
                        break
                    if self._stopped:
                        return            # drained (or cancelled) queue
                    self._wake.wait()
                fn, handle = self._queue.pop(key)
                self._running[key] = True
            try:
                result = fn()
                handle._finish(result)
            # a SimulatedCrash lands in handle.wait(), which re-raises it
            # in the waiter — delivery, not survival (and the bg retry
            # path counts it via _finish)
            except BaseException as e:  # greptlint: disable=GL02
                logger.exception("%s job %s failed", self.name, key)
                handle._finish(error=e)
            finally:
                with self._lock:
                    self._running.pop(key, None)
                    self._wake.notify_all()

    def stop(self, drain: bool = True) -> None:
        with self._lock:
            self._stopped = True
            if not drain:
                from ..errors import SchedulerStoppedError
                for _, handle in self._queue.values():
                    handle._finish(
                        error=SchedulerStoppedError("scheduler stopped"))
                self._queue.clear()
            self._wake.notify_all()
        for t in self._workers:
            t.join(timeout=30)

    def wait_idle(self, timeout: Optional[float] = None) -> None:
        """Block until the queue is empty and nothing is running (tests)."""
        import time
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            while self._queue or self._running:
                rem = None if deadline is None else deadline - time.time()
                if rem is not None and rem <= 0:
                    raise TimeoutError("scheduler not idle")
                self._wake.wait(rem if rem is None or rem > 0 else 0.01)


class RepeatedTask:
    """Fixed-interval background task (reference:
    src/common/runtime/src/repeated_task.rs)."""

    def __init__(self, interval_s: float, fn: Callable[[], None],
                 name: str = "repeated"):
        self.interval_s = interval_s
        self.fn = fn
        self.name = name
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, name=self.name,
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.fn()
            except Exception:  # noqa: BLE001
                logger.exception("repeated task %s failed", self.name)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
