"""greptsan: vector-clock happens-before data-race detector.

The dynamic tier above greptlint (syntactic) and the lock-order
detector (lock graph): greptsan watches *shared-state accesses* and
reports a race when two threads touch the same variable, at least one
writes, and NO chain of synchronization edges orders the accesses —
ThreadSanitizer's happens-before model (Serebryany et al.), rebuilt in
pure Python over this repo's existing instrumentation choke points.

Happens-before edges (see detector.py):

- ``TrackedLock``/``TrackedRLock`` release -> next acquire of the same
  lock instance (common/locks.py calls the hooks; Condition.wait/notify
  synchronize through the underlying tracked lock's release/reacquire).
- thread spawn -> child start, child end -> ``join()`` (all
  ``threading.Thread`` users, including ``runtime.new_thread``).
- pool ``submit()`` -> task start, task end -> ``Future.result()`` —
  every sanctioned pool path (spawn_bg/read/write, parallel_map/imap,
  the dist fan-out) runs through these.

Shared state opts in via :func:`tracked_state` (state.py) — a dict/
list/set subclass that records each access with the accessing thread's
vector clock and checks it against prior accesses. When the detector is
off (production), ``tracked_state`` returns its argument unchanged:
zero overhead, the TrackedLock/failpoint factory pattern.

Enablement: ``GREPTIME_RACE_CHECK`` set to a true value turns the
detector on (and lock tracking with it, common/locks.py); anything else
leaves it off. Unlike the reference's detector it never turns itself on
because pytest is loaded, and it refuses to install over another race
detector (detector.py). Races are *recorded*, not raised — execution
continues, and whatever runs the workload (tools/race_hammer.py, a
test's child process) fails if any unsuppressed race was observed. The
suppression baseline (.greptsan-baseline.json at the repo root,
crc-keyed like greptlint's) is read, never written, and kept at ZERO
entries: real races get fixed, not suppressed.
"""

from __future__ import annotations

from .detector import (DetectorConflictError, RaceReport, drain_races,
                       enabled, join_edges, load_suppressions, races, reset,
                       unsuppressed)
from .state import TrackedDict, TrackedList, TrackedSet, tracked_state

__all__ = ["enabled", "tracked_state", "TrackedDict", "TrackedList",
           "TrackedSet", "RaceReport", "races", "drain_races", "reset",
           "unsuppressed", "load_suppressions", "join_edges",
           "DetectorConflictError"]
