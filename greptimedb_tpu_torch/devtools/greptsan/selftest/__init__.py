"""Seeded concurrency bugs greptsan MUST catch (tests/test_torch_greptsan.py).

Each function plants one classic unsynchronized-sharing bug on its own
dedicated tracked structure and runs it to completion; the test asserts
a race report naming that structure fired. A detector that stops firing
on these is a silently-dead invariant — the same contract as
greptlint's selftest fixtures, but dynamic.

This directory is in greptlint's SKIP_DIRS (deliberate bugs must not
count against the repo scan) and excluded from mypy.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ....common.locks import TrackedLock
from .. import tracked_state


def unlocked_dict_mutation() -> str:
    """Two threads mutate one shared dict with NO common lock — the
    textbook unsynchronized read-modify-write both greptlint GL08 (when
    a module lock exists) and code review keep missing when the dict
    hides behind an attribute."""
    name = "greptsan.selftest.unlocked_dict"
    shared = tracked_state({}, name)
    barrier = threading.Barrier(2)

    def bump(tag: str) -> None:
        barrier.wait()
        for i in range(50):
            shared[tag] = i            # distinct keys: GIL-atomic...
            shared["total"] = shared.get("total", 0) + 1   # ...this isn't

    t1 = threading.Thread(target=bump, args=("a",), name="san-dict-a")
    t2 = threading.Thread(target=bump, args=("b",), name="san-dict-b")
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    return name


def notify_without_lock() -> str:
    """Producer notifies the consumer FIRST and publishes the payload
    after — the waiter can wake, reacquire the lock and read state the
    producer has not written yet. The happens-before chain through the
    condition's lock covers only what preceded the producer's release,
    which the late write does not."""
    name = "greptsan.selftest.notify_state"
    state = tracked_state({}, name)
    lk = TrackedLock("greptsan.selftest.notify_lock", force=True)
    cond = threading.Condition(lk)
    consumer_in_wait = threading.Barrier(2)

    def producer() -> None:
        consumer_in_wait.wait()
        time.sleep(0.05)               # let the consumer park in wait()
        with cond:
            cond.notify()
        state["ready"] = 1             # BUG: published after the wakeup

    def consumer() -> None:
        with cond:
            consumer_in_wait.wait()
            cond.wait(timeout=5)
        state.get("ready")             # unordered vs the late publish

    t1 = threading.Thread(target=producer, name="san-notify-producer")
    t2 = threading.Thread(target=consumer, name="san-notify-consumer")
    t2.start()
    t1.start()
    t1.join()
    t2.join()
    return name


def pool_result_before_join() -> str:
    """The caller polls ``future.done()`` and reads the task's output
    state WITHOUT calling ``result()`` — ``done()`` is a completion
    *flag*, not a synchronization edge, so nothing orders the worker's
    writes before the caller's read."""
    name = "greptsan.selftest.pool_state"
    state = tracked_state({}, name)
    pool = ThreadPoolExecutor(max_workers=1,
                              thread_name_prefix="san-pool")
    try:
        fut = pool.submit(lambda: state.__setitem__("x", 1))
        while not fut.done():          # BUG: done() instead of result()
            time.sleep(0.005)
        state.get("x")
        fut.result()                   # too late: the read already raced
    finally:
        pool.shutdown(wait=True)
    return name
