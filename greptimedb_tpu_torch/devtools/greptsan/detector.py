"""Vector-clock happens-before engine + synchronization-edge hooks.

Model (FastTrack-flavored, Serebryany et al.'s ThreadSanitizer core):

- every thread carries a vector clock ``C_t: tid -> epoch``; its own
  component advances at each *release point* (lock release, spawn,
  submit, Event.set, task completion);
- a synchronization object (tracked lock, Thread, Future, Event)
  carries the clock snapshot of its last release point; the matching
  *acquire point* (lock acquire, join, result, wait) joins that
  snapshot into the acquirer's clock;
- an access by thread ``u`` at epoch ``e`` happens-before the current
  operation of thread ``t`` iff ``e <= C_t[u]``. Two accesses to the
  same variable, at least one a write, neither ordered — that is a
  data race, reported with both stacks and both sides' held locks.

Races are recorded (deduplicated by a crc key, the suppression-baseline
key), never raised: the run continues, and whoever drives the run
(tools/race_hammer.py, a test's child process) reads :func:`races` and
fails on any that :func:`unsuppressed` keeps.

Generation resets: :func:`new_generation` clears variable metadata and
lazily resets thread clocks between independent workloads. Clocks would
otherwise accumulate one component per thread ever spawned, making
every clock join O(run) instead of O(workload). Sound for intra-workload
races: an edge can only order accesses that come after it, and accesses
+ the edges that order them always live in the same workload, hence the
same generation.

Enablement differs from the reference (greptimedb_tpu's detector, which
also turns itself on whenever pytest is loaded): this detector is on
only when ``GREPTIME_RACE_CHECK`` is set to a true value. A process
holds one race detector, because each patches ``threading`` and
``concurrent.futures`` process-wide; a test session may already run the
reference's. So when this one is enabled and finds
``threading.Thread.start`` patched by another module, it raises
:class:`DetectorConflictError` at import, naming that module, and
installs nothing over it.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

logger = logging.getLogger(__name__)

__all__ = ["enabled", "RaceReport", "races", "drain_races", "reset",
           "new_generation", "unsuppressed", "load_suppressions",
           "record_access", "join_edges", "DEFAULT_BASELINE",
           "DetectorConflictError", "accesses"]

#: the repo's suppression baseline (version 1, zero entries): read as
#: the default, never written
DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), ".greptsan-baseline.json")

#: synchronization edges that create happens-before (the README table)
join_edges = (
    "TrackedLock/TrackedRLock release -> acquire (Condition wait/notify "
    "synchronizes through the lock's release/reacquire)",
    "threading.Thread start -> child run, child exit -> join()",
    "Executor.submit -> task start, task end -> Future.result()",
    "threading.Event set -> wait()",
)


def _env_enabled() -> bool:
    v = os.environ.get("GREPTIME_RACE_CHECK")
    return v is not None and \
        v.strip().lower() not in ("", "0", "false", "off", "no")


class DetectorConflictError(RuntimeError):
    """The detector was enabled in a process whose ``threading`` another
    race detector has already patched."""


_ENABLED: bool = _env_enabled()


def enabled() -> bool:
    return _ENABLED


# ---------------------------------------------------------------------
# per-thread state: tid + vector clock, generation-scoped
# ---------------------------------------------------------------------

_tls = threading.local()
_san_lock = threading.Lock()          # guards _vars/_races/_tid_seq
_tid_seq = [0]
_gen = [0]


def _ctx() -> Any:
    """This thread's (tid, clock), lazily created and generation-fresh."""
    tid = getattr(_tls, "tid", None)
    if tid is None:
        with _san_lock:
            _tid_seq[0] += 1
            tid = _tls.tid = _tid_seq[0]
        _tls.gen = _gen[0]
        _tls.clock = {tid: 1}
    elif getattr(_tls, "gen", -1) != _gen[0]:
        _tls.gen = _gen[0]
        _tls.clock = {tid: 1}
    return _tls


def _tick() -> None:
    st = _ctx()
    st.clock[st.tid] += 1


def snapshot() -> Tuple[int, Dict[int, int]]:
    """(generation, clock copy) of this thread at a release point; the
    thread's own component then advances so later events are not covered
    by the snapshot."""
    st = _ctx()
    snap = (st.gen, dict(st.clock))
    st.clock[st.tid] += 1
    return snap


def join(snap: Optional[Tuple[int, Dict[int, int]]]) -> None:
    """Acquire point: merge a release-point snapshot into this thread's
    clock. Snapshots from an earlier generation are stale (their edges
    cannot order any current-generation access) and are ignored."""
    if not snap:
        return
    gen, clock = snap
    st = _ctx()
    if gen != st.gen:
        return
    mine = st.clock
    for tid, epoch in clock.items():
        if mine.get(tid, 0) < epoch:
            mine[tid] = epoch


def new_generation() -> None:
    """Forget variable metadata and lazily reset clocks (between-test
    hygiene; recorded races are kept — the run's verdict reads those)."""
    with _san_lock:
        _gen[0] += 1
        _vars.clear()


def reset() -> None:
    """new_generation + drop recorded races and access counts (selftest
    isolation)."""
    with _san_lock:
        _gen[0] += 1
        _vars.clear()
        _races.clear()
        _reported.clear()
        _accesses.clear()


def accesses() -> Dict[str, int]:
    """Tracked accesses recorded since the last :func:`reset`, by state
    name: a run that recorded none watched nothing (port-only)."""
    with _san_lock:
        return dict(_accesses)


# ---------------------------------------------------------------------
# race reports
# ---------------------------------------------------------------------

@dataclass
class Access:
    tid: int
    epoch: int
    thread_name: str
    write: bool
    stack: Tuple[Tuple[str, int, str], ...]
    held: Tuple[str, ...]

    def render(self) -> str:
        frames = " <- ".join(f"{os.path.basename(f)}:{ln} in {fn}"
                             for f, ln, fn in self.stack) or "<no frames>"
        held = ", ".join(self.held) if self.held else "none"
        rw = "write" if self.write else "read"
        return (f"{rw} by thread {self.thread_name!r} (locks held: "
                f"{held})\n      at {frames}")


@dataclass
class RaceReport:
    state: str
    key: object
    kind: str                       # write-write / read-write / write-read
    prior: Access
    current: Access

    def suppression_key(self) -> str:
        """crc-keyed like greptlint's baseline: stable across line moves
        elsewhere, specific enough to never mask a different race."""
        sig = "|".join([self.state, self.kind] +
                       [f"{os.path.basename(f)}:{fn}"
                        for f, _ln, fn in self.prior.stack] +
                       [f"{os.path.basename(f)}:{fn}"
                        for f, _ln, fn in self.current.stack])
        crc = zlib.crc32(sig.encode()) & 0xFFFFFFFF
        return f"{self.state}:{crc:08x}"

    def render(self) -> str:
        both_held = set(self.prior.held) & set(self.current.held)
        if both_held:
            edge = (f"both sides hold {sorted(both_held)} yet no "
                    f"release->acquire edge ordered them (lock taken "
                    f"after the access?)")
        else:
            edge = ("no happens-before edge orders the accesses: the "
                    "sides share no lock, and no thread-join / "
                    "Future.result / Event.wait chain connects them — "
                    "guard the state with one TrackedLock on BOTH sides "
                    "or hand it off through a pool result/join")
        return (f"DATA RACE ({self.kind}) on {self.state}"
                f"{f'[{self.key!r}]' if self.key is not None else ''}\n"
                f"  prior   {self.prior.render()}\n"
                f"  current {self.current.render()}\n"
                f"  missing edge: {edge}\n"
                f"  suppression key: {self.suppression_key()}")


class _Var:
    __slots__ = ("write", "reads")

    def __init__(self) -> None:
        self.write: Optional[Access] = None
        self.reads: Dict[int, Access] = {}


_vars: Dict[Tuple[int, object], _Var] = {}
_races: List[RaceReport] = []
_reported: Set[str] = set()
_accesses: Dict[str, int] = {}


def races() -> List[RaceReport]:
    with _san_lock:
        return list(_races)


def drain_races() -> List[RaceReport]:
    with _san_lock:
        out = list(_races)
        _races.clear()
        _reported.clear()
        return out


#: the detector's own machinery frames, skipped in captured stacks —
#: exact paths, NOT a substring: races seeded under greptsan/selftest/
#: must render their real frames (and key their suppression crc off
#: them), or distinct races would collapse onto one threading.py key
_OWN_FILES = frozenset({
    __file__,
    os.path.join(os.path.dirname(__file__), "state.py"),
})


def _capture_stack(skip: int) -> Tuple[Tuple[str, int, str], ...]:
    """Innermost 4 caller frames as (file, line, func) — cheap enough
    for per-access capture, informative enough for a report."""
    frames = []
    try:
        f = sys._getframe(skip)
    except ValueError:
        return ()
    while f is not None and len(frames) < 4:
        code = f.f_code
        if code.co_filename not in _OWN_FILES:
            frames.append((code.co_filename, f.f_lineno, code.co_name))
        f = f.f_back
    return tuple(frames)


def _held_lock_names() -> Tuple[str, ...]:
    try:
        from ...common import locks
        return tuple(locks.held_locks())
    except Exception:  # noqa: BLE001 — introspection only, never fail
        return ()


def _report(state: str, key: object, kind: str, prior: Access,
            current: Access) -> Optional[RaceReport]:
    """Record a deduplicated race under _san_lock; caller logs OUTSIDE
    the lock (the logging module takes its own handler lock — nesting it
    under ours would hand the two-lock-cycle bug to the race detector
    itself)."""
    r = RaceReport(state, key, kind, prior, current)
    skey = r.suppression_key()
    if skey in _reported:
        return None
    # invariant: only record_access calls _report, under _san_lock
    _reported.add(skey)      # greptlint: disable=GL08
    _races.append(r)         # greptlint: disable=GL08
    return r


def record_access(state_name: str, state_id: int, key: object,
                  write: bool, *, skip: int = 2) -> None:
    """The state.py proxies call this on every tracked access."""
    if not _ENABLED:
        return
    st = _ctx()
    me, clock = st.tid, st.clock
    acc = Access(me, clock[me], threading.current_thread().name, write,
                 _capture_stack(skip), _held_lock_names())
    try:
        vkey = (state_id, key)
        hash(vkey)
    except TypeError:
        vkey = (state_id, repr(key))
    found: List[RaceReport] = []
    with _san_lock:
        _accesses[state_name] = _accesses.get(state_name, 0) + 1
        var = _vars.get(vkey)
        if var is None:
            var = _vars[vkey] = _Var()
        w = var.write
        if w is not None and w.tid != me and w.epoch > clock.get(w.tid, 0):
            rep = _report(state_name, key,
                          "write-write" if write else "write-read", w, acc)
            if rep is not None:
                found.append(rep)
        if write:
            for rt, r in var.reads.items():
                if rt != me and r.epoch > clock.get(rt, 0):
                    rep = _report(state_name, key, "read-write", r, acc)
                    if rep is not None:
                        found.append(rep)
            var.write = acc
            var.reads.clear()
        else:
            var.reads[me] = acc
    for rep in found:
        logger.error("greptsan: %s", rep.render())


# ---------------------------------------------------------------------
# suppression baseline (kept at ZERO entries; emergencies only)
# ---------------------------------------------------------------------

def load_suppressions(path: Optional[str] = None) -> Dict[str, str]:
    """{suppression_key: justification}. Missing file = no suppressions."""
    if path is None:
        path = DEFAULT_BASELINE
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("version") != 1:
        raise ValueError(f"unsupported greptsan baseline format in {path}")
    return {str(k): str(v) for k, v in doc.get("suppressions", {}).items()}


def unsuppressed(reports: List[RaceReport],
                 path: Optional[str] = None) -> List[RaceReport]:
    sup = load_suppressions(path)
    return [r for r in reports if r.suppression_key() not in sup]


# ---------------------------------------------------------------------
# happens-before hooks: locks (via common/locks), threads, pools, events
# ---------------------------------------------------------------------

def _on_lock_acquire(lock: Any) -> None:
    join(getattr(lock, "_san_clock", None))


def _on_lock_release(lock: Any) -> None:
    gen_clock = getattr(lock, "_san_clock", None)
    snap = snapshot()
    if gen_clock and gen_clock[0] == snap[0]:
        merged = gen_clock[1]
        for tid, epoch in snap[1].items():
            if merged.get(tid, 0) < epoch:
                merged[tid] = epoch
        lock._san_clock = (snap[0], merged)
    else:
        lock._san_clock = snap


def _install_lock_hooks() -> None:
    from ...common import locks
    locks.set_race_hooks(_on_lock_acquire, _on_lock_release)


_PATCHED = False


def _install_patches() -> None:
    """Interpose the stdlib synchronization points, the way TSan wraps
    pthread_create/join — test-mode only, guarded by enabled()."""
    global _PATCHED
    if _PATCHED:
        return
    _PATCHED = True

    import concurrent.futures as _cf

    # ---- thread spawn/join edges ----
    _orig_start = threading.Thread.start
    _orig_run = threading.Thread.run
    _orig_join = threading.Thread.join

    def start(self: threading.Thread) -> None:
        self._gsan_spawn = snapshot()
        _orig_start(self)

    def run(self: threading.Thread) -> None:
        join(getattr(self, "_gsan_spawn", None))
        try:
            _orig_run(self)
        finally:
            self._gsan_final = snapshot()

    def join_(self: threading.Thread,
              timeout: Optional[float] = None) -> None:
        _orig_join(self, timeout)
        if not self.is_alive():
            join(getattr(self, "_gsan_final", None))

    threading.Thread.start = start                 # type: ignore[method-assign]
    threading.Thread.run = run                     # type: ignore[method-assign]
    threading.Thread.join = join_                  # type: ignore[method-assign]

    # Timer overrides run() (so the Thread.run patch never executes);
    # give it the same spawn-edge join + final snapshot
    _orig_timer_run = threading.Timer.run

    def timer_run(self: threading.Timer) -> None:
        join(getattr(self, "_gsan_spawn", None))
        try:
            _orig_timer_run(self)
        finally:
            self._gsan_final = snapshot()

    threading.Timer.run = timer_run                # type: ignore[method-assign]

    # ---- pool submit -> task start, task end -> result() edges ----
    _orig_submit = _cf.ThreadPoolExecutor.submit

    def submit(self: Any, fn: Callable, /, *args: Any,
               **kwargs: Any) -> Any:
        snap = snapshot()
        import functools

        @functools.wraps(fn)
        def task(*a: Any, **k: Any) -> Any:
            join(snap)
            return fn(*a, **k)

        return _orig_submit(self, task, *args, **kwargs)

    _cf.ThreadPoolExecutor.submit = submit         # type: ignore[method-assign]

    _orig_set_result = _cf.Future.set_result
    _orig_set_exc = _cf.Future.set_exception
    _orig_result = _cf.Future.result
    _orig_exception = _cf.Future.exception

    def set_result(self: Any, result: Any) -> None:
        self._gsan_done = snapshot()
        _orig_set_result(self, result)

    def set_exception(self: Any, exc: Any) -> None:
        self._gsan_done = snapshot()
        _orig_set_exc(self, exc)

    def result(self: Any, timeout: Optional[float] = None) -> Any:
        try:
            return _orig_result(self, timeout)
        finally:
            join(getattr(self, "_gsan_done", None))

    def exception(self: Any, timeout: Optional[float] = None) -> Any:
        try:
            return _orig_exception(self, timeout)
        finally:
            join(getattr(self, "_gsan_done", None))

    _cf.Future.set_result = set_result             # type: ignore[method-assign]
    _cf.Future.set_exception = set_exception       # type: ignore[method-assign]
    _cf.Future.result = result                     # type: ignore[method-assign]
    _cf.Future.exception = exception               # type: ignore[method-assign]

    # ---- Event set -> wait edge (JobHandle/stop-flag handoffs) ----
    _orig_event_set = threading.Event.set
    _orig_event_wait = threading.Event.wait

    def event_set(self: threading.Event) -> None:
        self._gsan_set = snapshot()
        _orig_event_set(self)

    def event_wait(self: threading.Event,
                   timeout: Optional[float] = None) -> bool:
        ok = _orig_event_wait(self, timeout)
        if ok:
            join(getattr(self, "_gsan_set", None))
        return ok

    threading.Event.set = event_set                # type: ignore[method-assign]
    threading.Event.wait = event_wait              # type: ignore[method-assign]


def _check_unpatched() -> None:
    owner = getattr(threading.Thread.start, "__module__", "threading")
    if owner != "threading":
        raise DetectorConflictError(
            f"GREPTIME_RACE_CHECK is set, but threading.Thread.start is "
            f"already patched by {owner!r}: one race detector per process "
            f"(run this one in a process that imports no other)")


if _ENABLED:
    _check_unpatched()
    _install_lock_hooks()
    _install_patches()
