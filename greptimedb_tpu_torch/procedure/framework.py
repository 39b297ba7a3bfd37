"""Procedure trait, local manager/runner, object-store state persistence.

Reference mapping:
- `Procedure` / `Status::{Executing, Done}` — procedure.rs:84
- `LocalManager.submit` + `Runner` retry loop — local.rs:307, runner
- `ObjectStateStore`: step JSON at procedures/{id}/{step}.step, commit
  marker on completion — store/state_store.rs
- `Watcher` — watcher.rs
- recovery: load the latest persisted step of uncommitted procedures and
  re-run from there — local.rs:383-417

Single-process semantics: a procedure's `execute(ctx)` is called
repeatedly; each return of `Status.executing(persist=True)` checkpoints
`dump()`. Exceptions marked retryable (`RetryLater`) back off and retry;
other exceptions fail the procedure (state kept for inspection).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..errors import GreptimeError

logger = logging.getLogger(__name__)

PROC_PREFIX = "procedures"


class RetryLater(GreptimeError):
    """Raise from execute() to request a backoff retry (reference:
    Error::retry_later / Status::retry_later)."""


@dataclass
class Status:
    state: str                       # "executing" | "done"
    persist: bool = True

    @staticmethod
    def executing(persist: bool = True) -> "Status":
        return Status("executing", persist)

    @staticmethod
    def done() -> "Status":
        return Status("done", False)

    @property
    def is_done(self) -> bool:
        return self.state == "done"


class Procedure:
    """One resumable multi-step operation."""

    #: registry key for recovery (reference: type_name())
    type_name: str = "Procedure"

    def execute(self, ctx: "Context") -> Status:
        raise NotImplementedError

    def dump(self) -> dict:
        """JSON state sufficient for the loader to reconstruct."""
        raise NotImplementedError

    def lock_key(self) -> Optional[str]:
        """Procedures sharing a key run serialized (reference: LockMap)."""
        return None

    def rollback(self, ctx: "Context") -> None:
        """Best-effort undo when the procedure fails permanently."""


@dataclass
class Context:
    procedure_id: str


class Watcher:
    def __init__(self):
        self._event = threading.Event()
        self._error: Optional[BaseException] = None

    def _finish(self, error: Optional[BaseException]) -> None:
        self._error = error
        self._event.set()

    def wait(self, timeout: Optional[float] = 30.0) -> None:
        if not self._event.wait(timeout):
            raise TimeoutError("procedure did not finish in time")
        if self._error is not None:
            raise self._error


class ProcedureManager:
    """LocalManager: submit/run/persist/recover procedures."""

    def __init__(self, store, max_retries: int = 3,
                 retry_delay_s: float = 0.05, run_async: bool = False):
        self.store = store
        self.max_retries = max_retries
        self.retry_delay_s = retry_delay_s
        self.run_async = run_async
        self._loaders: Dict[str, Callable[[dict], Procedure]] = {}
        self._locks: Dict[str, threading.Lock] = {}
        self._locks_guard = threading.Lock()

    # ---- registry ----
    def register_loader(self, type_name: str,
                        loader: Callable[[dict], Procedure]) -> None:
        self._loaders[type_name] = loader

    # ---- state store ----
    def _step_key(self, pid: str, step: int) -> str:
        return f"{PROC_PREFIX}/{pid}/{step:010d}.step"

    def _commit_key(self, pid: str) -> str:
        return f"{PROC_PREFIX}/{pid}/commit"

    def _persist(self, pid: str, step: int, proc: Procedure) -> None:
        self.store.write(self._step_key(pid, step), json.dumps({
            "type": proc.type_name, "step": step, "data": proc.dump(),
        }).encode())

    def _cleanup(self, pid: str) -> None:
        for key in self.store.list(f"{PROC_PREFIX}/{pid}/"):
            self.store.delete(key)

    # ---- execution ----
    def submit(self, proc: Procedure,
               procedure_id: Optional[str] = None) -> Watcher:
        pid = procedure_id or uuid.uuid4().hex
        watcher = Watcher()
        if self.run_async:
            from ..common.runtime import new_thread
            t = new_thread(self._run, name=f"procedure-{pid}",
                           args=(proc, pid, watcher), daemon=True)
            t.start()
        else:
            self._run(proc, pid, watcher)
        return watcher

    def _lock_for(self, key: str) -> threading.Lock:
        with self._locks_guard:
            return self._locks.setdefault(key, threading.Lock())

    def _run(self, proc: Procedure, pid: str, watcher: Watcher) -> None:
        ctx = Context(procedure_id=pid)
        lock = self._lock_for(proc.lock_key()) \
            if proc.lock_key() is not None else None
        if lock is not None:
            lock.acquire()
        try:
            self._persist(pid, 0, proc)       # submitted state survives
            step = 1
            retries = 0
            while True:
                try:
                    status = proc.execute(ctx)
                except RetryLater:
                    retries += 1
                    if retries > self.max_retries:
                        raise
                    time.sleep(self.retry_delay_s * (2 ** (retries - 1)))
                    continue
                retries = 0
                if status.is_done:
                    self.store.write(self._commit_key(pid), b"done")
                    self._cleanup(pid)
                    watcher._finish(None)
                    return
                if status.persist:
                    self._persist(pid, step, proc)
                    step += 1
        # a SimulatedCrash lands in watcher.wait(), which re-raises it in
        # the submitter — delivery, not survival
        except BaseException as e:  # greptlint: disable=GL02
            logger.exception("procedure %s (%s) failed", pid,
                             proc.type_name)
            try:
                proc.rollback(ctx)
            except Exception:  # noqa: BLE001
                logger.exception("rollback of %s failed", pid)
            watcher._finish(e)
        finally:
            if lock is not None:
                lock.release()

    # ---- recovery ----
    def recover(self) -> List[str]:
        """Resume every uncommitted procedure from its last persisted
        step. Returns the recovered procedure ids."""
        by_pid: Dict[str, List[str]] = {}
        for key in self.store.list(f"{PROC_PREFIX}/"):
            parts = key.split("/")
            if len(parts) >= 3:
                by_pid.setdefault(parts[1], []).append(key)
        recovered = []
        for pid, keys in sorted(by_pid.items()):
            if any(k.endswith("/commit") for k in keys):
                self._cleanup(pid)            # finished; late GC
                continue
            steps = sorted(k for k in keys if k.endswith(".step"))
            if not steps:
                continue
            doc = json.loads(self.store.read(steps[-1]))
            loader = self._loaders.get(doc["type"])
            if loader is None:
                logger.warning("no loader for procedure type %r; leaving "
                               "%s for manual inspection", doc["type"], pid)
                continue
            proc = loader(doc["data"])
            watcher = self.submit(proc, procedure_id=pid)
            if not self.run_async:
                try:
                    watcher.wait(timeout=None)
                except Exception:  # noqa: BLE001
                    logger.exception("recovered procedure %s failed", pid)
            recovered.append(pid)
        return recovered
