"""Runtime lock-order race detector (the dynamic half of greptlint).

Reference behavior: the reference leans on the Rust compiler + clippy +
loom for concurrency hygiene; a Python rebuild has none of those, so the
storage layer's ~10 locks are wrapped in :func:`TrackedLock` /
:func:`TrackedRLock`, a lockdep-style checker that builds a global
*lock-order graph* while tests run:

- Every **blocking** acquisition with other locks held records a
  directed edge ``held_class -> acquired_class`` (keyed by the lock's
  declared *name*, i.e. its class — two distinct regions' writer locks
  share a node, exactly like kernel lockdep).
- An edge that would close a cycle (``A -> B`` recorded while a path
  ``B ->* A`` exists) raises :class:`LockOrderError` **before blocking**
  — a potential ABBA deadlock is reported with both acquisition stacks
  instead of hanging the suite.
- Nesting two *different instances* of the same lock class is a
  self-edge and raises for the same reason (no instance ordering exists;
  re-entrant re-acquisition of the *same* instance is fine).
- While any lock created with ``io_ok=False`` (pure in-memory state:
  version transitions, memtable index, scheduler queue, purger queue)
  is held, reaching a *blocking-I/O failpoint site*
  (``objstore_*``, ``wal_fsync``, ``cache_read``, ...) raises
  :class:`IoUnderLockError` — the static analyzer cannot see through
  call chains, this catches I/O-under-lock at runtime.

Zero overhead in production, same pattern as ``common/failpoint.py``:
:func:`TrackedLock` is a **factory** that returns a plain
``threading.Lock`` unless the detector is enabled, so the inactive mode
costs literally nothing per acquire.
Enablement is decided at import: ``GREPTIME_LOCK_CHECK=1`` forces on,
``GREPTIME_LOCK_CHECK=0`` forces off, and otherwise the detector turns
itself on when running under pytest (``pytest`` already imported).
``GREPTIME_RACE_CHECK`` set to a true value forces it on as well: the
port's race detector (devtools/greptsan) takes its lock edges from the
acquire/release hooks below.

Reference: greptimedb_tpu/common/locks.py. One difference: a race
detector that refuses to install (another one already patched
``threading`` in this process) fails the import here, rather than
leaving the process silently unwatched.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple, Union

logger = logging.getLogger(__name__)

__all__ = ["TrackedLock", "TrackedRLock", "LockOrderError",
           "IoUnderLockError", "enabled", "reset_graph", "order_edges",
           "held_locks", "IO_FAILPOINT_SITES"]


class LockOrderError(RuntimeError):
    """A lock acquisition would close a cycle in the lock-order graph —
    some other code path takes the same locks in the opposite order, so
    the two can deadlock against each other."""


class IoUnderLockError(LockOrderError):
    """A blocking-I/O failpoint site was reached while holding a lock
    declared ``io_ok=False`` (in-memory-only critical section)."""


def _env_enabled() -> bool:
    # greptsan (devtools/greptsan) derives its happens-before edges from
    # tracked acquire/release events, so forcing the race detector on
    # forces lock tracking on too — even over an explicit
    # GREPTIME_LOCK_CHECK=0 (raceless edges would report every
    # lock-protected access as a data race)
    r = os.environ.get("GREPTIME_RACE_CHECK")
    if r is not None and r.strip().lower() not in ("", "0", "false",
                                                   "off", "no"):
        return True
    v = os.environ.get("GREPTIME_LOCK_CHECK")
    if v is not None:
        return v.strip().lower() not in ("", "0", "false", "off", "no")
    return "pytest" in sys.modules


_ENABLED: bool = _env_enabled()

#: (on_acquire, on_release) installed by greptsan when the race detector
#: is enabled — every tracked acquisition/release (including the
#: Condition wait release/reacquire cycle) reports here so vector clocks
#: pick up the release->acquire happens-before edge. None otherwise:
#: one is-None branch on the tracked (test-only) path.
_RACE_HOOKS: Optional[Tuple] = None


def set_race_hooks(on_acquire, on_release) -> None:
    global _RACE_HOOKS
    _RACE_HOOKS = (on_acquire, on_release) \
        if on_acquire is not None else None

#: failpoint sites that sit on blocking-I/O paths; reaching one while an
#: ``io_ok=False`` lock is held is a bug even when no failpoint is armed
IO_FAILPOINT_SITES = frozenset({
    "objstore_read", "objstore_write", "objstore_delete",
    "objstore_request", "wal_append", "wal_fsync", "cache_read",
    "sst_write", "purger_delete", "scan_cache_incremental",
})

_tls = threading.local()

_graph_lock = threading.Lock()
#: adjacency: lock-class name -> set of lock-class names acquired while
#: the key was held (first blocking acquisition records the edge)
_edges: Dict[str, Set[str]] = {}
#: (a, b) -> formatted stack of the acquisition that first recorded a->b
_edge_stacks: Dict[Tuple[str, str], str] = {}


def _held() -> List["_Tracked"]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = []
        _tls.held = held
    return held


def enabled() -> bool:
    return _ENABLED


def reset_graph() -> None:
    """Forget every recorded edge (test isolation)."""
    with _graph_lock:
        _edges.clear()
        _edge_stacks.clear()


def order_edges() -> Dict[str, Set[str]]:
    """Snapshot of the lock-order graph (introspection / tests)."""
    with _graph_lock:
        return {k: set(v) for k, v in _edges.items()}


def held_locks() -> List[str]:
    """Names of the locks the calling thread currently holds."""
    return [lk.name for lk in _held()]


def _short_stack(skip: int = 3) -> str:
    return "".join(traceback.format_stack()[:-skip][-8:])


def _path_exists(src: str, dst: str) -> Optional[List[str]]:
    """DFS under _graph_lock: a path src ->* dst, or None."""
    stack: List[Tuple[str, List[str]]] = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class _Tracked:
    """Active-mode wrapper. Never constructed when the detector is off —
    the TrackedLock/TrackedRLock factories return raw locks instead."""

    __slots__ = ("_inner", "name", "io_ok", "_reentrant", "_san_clock")

    def __init__(self, inner: Union[threading.Lock, threading.RLock],
                 name: str, io_ok: bool, reentrant: bool):
        self._inner = inner
        self.name = name
        self.io_ok = io_ok
        self._reentrant = reentrant
        #: greptsan's per-lock vector-clock snapshot (generation, clock);
        #: read/written only while the lock is held, so the lock itself
        #: is its synchronization
        self._san_clock = None

    # -- ordering ----------------------------------------------------
    def _check_order(self, held: List["_Tracked"]) -> None:
        """Record edges held->self and raise BEFORE blocking if any edge
        closes a cycle (so an ABBA pair reports instead of deadlocking)."""
        me = self.name
        stack_txt: Optional[str] = None
        for h in held:
            a = h.name
            if a == me:
                # two *instances* of the same class nested without any
                # ordering rule — the mirror nesting deadlocks
                raise LockOrderError(
                    f"nested acquisition of two {me!r} lock instances "
                    f"(no instance ordering exists)\n{_short_stack()}")
            with _graph_lock:
                if me in _edges.get(a, ()):
                    continue                      # edge already known
                path = _path_exists(me, a)
                if path is not None:
                    prior = "".join(
                        f"  {x} -> {y} first seen at:\n"
                        f"{_edge_stacks.get((x, y), '    <unknown>')}"
                        for x, y in zip(path, path[1:]))
                    raise LockOrderError(
                        f"lock-order cycle: acquiring {me!r} while "
                        f"holding {a!r}, but the inverse order "
                        f"{' -> '.join(path)} is already established:\n"
                        f"{prior}current acquisition:\n{_short_stack()}")
                if stack_txt is None:
                    stack_txt = _short_stack()
                _edges.setdefault(a, set()).add(me)
                _edge_stacks[(a, me)] = stack_txt

    # -- lock protocol ----------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held()
        already = any(h is self for h in held)
        if already and not self._reentrant:
            raise LockOrderError(
                f"non-reentrant lock {self.name!r} re-acquired by its "
                f"owner (self-deadlock)\n{_short_stack()}")
        if blocking and not already and held:
            self._check_order(held)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            held.append(self)
            if _RACE_HOOKS is not None:
                _RACE_HOOKS[0](self)
        return ok

    def release(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        if _RACE_HOOKS is not None:
            _RACE_HOOKS[1](self)       # while still holding: the clock
        self._inner.release()          # publish races with the release

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: object) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- threading.Condition protocol -------------------------------
    # Condition(lock) probes for these at construction; without them it
    # falls back to `acquire(False)` tricks that misread a tracked lock
    # (the owner probing its own non-reentrant lock looks like a
    # self-deadlock). Waiters keep the held-list consistent across the
    # release/park/reacquire cycle; the reacquire does NOT re-run order
    # checking — it restores an ordering that was already vetted.

    def _is_owned(self) -> bool:
        return any(h is self for h in _held())

    def _release_save(self):
        held = _held()
        count = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                count += 1
        if _RACE_HOOKS is not None:
            _RACE_HOOKS[1](self)       # cond.wait releases: a real edge
        if self._reentrant:
            return (self._inner._release_save(), count)
        self._inner.release()
        return (None, count)

    def _acquire_restore(self, state: tuple) -> None:
        inner_state, count = state
        if self._reentrant:
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        _held().extend([self] * count)
        if _RACE_HOOKS is not None:
            _RACE_HOOKS[0](self)       # waiter reacquired: join the clock

    def __repr__(self) -> str:
        kind = "TrackedRLock" if self._reentrant else "TrackedLock"
        return f"<{kind} {self.name!r} io_ok={self.io_ok}>"


def TrackedLock(name: str, *, io_ok: bool = True,
                force: bool = False) -> Union[threading.Lock, _Tracked]:
    """A mutex that participates in lock-order checking when the
    detector is enabled; a plain ``threading.Lock`` otherwise.

    ``name`` is the lock *class* (``"storage.cache"``), shared by every
    instance guarding the same kind of state. ``io_ok=False`` declares
    the critical section in-memory-only: blocking-I/O failpoint sites
    reached while held raise :class:`IoUnderLockError`."""
    if not (_ENABLED or force):
        return threading.Lock()
    return _Tracked(threading.Lock(), name, io_ok, reentrant=False)


def TrackedRLock(name: str, *, io_ok: bool = True,
                 force: bool = False) -> Union[threading.RLock, _Tracked]:
    """Re-entrant variant of :func:`TrackedLock`."""
    if not (_ENABLED or force):
        return threading.RLock()
    return _Tracked(threading.RLock(), name, io_ok, reentrant=True)


# -- blocking-I/O-under-lock check -----------------------------------

def note_io_site(site: str) -> None:
    """Called by ``failpoint.fail_point``/``fires`` on every evaluation
    while the detector is enabled: raise if an in-memory-only lock is
    held across a blocking-I/O site."""
    if site not in IO_FAILPOINT_SITES:
        return
    held = getattr(_tls, "held", None)
    if not held:
        return
    for lk in held:
        if not lk.io_ok:
            raise IoUnderLockError(
                f"blocking-I/O failpoint site {site!r} reached while "
                f"holding in-memory-only lock {lk.name!r} (held: "
                f"{[h.name for h in held]})\n{_short_stack()}")


def _install_io_hook() -> None:
    from . import failpoint
    failpoint.set_io_site_hook(note_io_site)


if _ENABLED:
    _install_io_hook()
    # the race detector (devtools/greptsan) decides its own enablement
    # (GREPTIME_RACE_CHECK); importing it here installs its
    # lock/thread/pool happens-before hooks without requiring every
    # entry point to know it exists. Guarded: a trimmed deployment that
    # ships common/ without devtools/ must still lock-check. Only a
    # missing module is tolerated: a detector that refuses to install
    # over another one raises through this import.
    try:
        from ..devtools.greptsan import detector as _greptsan  # noqa: F401
    except ImportError as e:
        logger.debug("greptsan unavailable; lock-order checking only: %s", e)
