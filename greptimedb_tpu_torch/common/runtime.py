"""Named runtimes: shared thread pools + repeated tasks.

Reference behavior: src/common/runtime — named tokio runtimes with
`spawn_bg/spawn_read/spawn_write` globals (global.rs) and `RepeatedTask`
(repeated_task.rs). Python twin: shared ThreadPoolExecutors sized for
their roles; background storage jobs, scan fan-out, protocol write
handling, and the distributed scatter-gather each land on their own pool
so a flood of one cannot starve the others.

The ``dist`` pool is the long-lived executor behind the frontend's
datanode fan-out (frontend/distributed.py): RPCs to N datanodes overlap
instead of summing, and the per-query in-flight window is bounded by the
``dist_fanout`` knob (``SET dist_fanout`` / ``GREPTIME_DIST_FANOUT``)
so one wide query cannot monopolize every connection.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Callable, Iterable, Iterator, Optional

from ..storage.scheduler import RepeatedTask  # canonical impl, re-export

__all__ = ["RepeatedTask", "spawn_bg", "spawn_read", "spawn_write",
           "bg_runtime", "read_runtime", "write_runtime", "dist_runtime",
           "dist_fanout", "configure_dist_fanout", "env_int",
           "shutdown_runtimes", "new_thread", "transient_executor",
           "spawn_on"]

_lock = threading.Lock()
_pools = {}

_SIZES = {"bg": 4, "read": 8, "write": 8, "dist": 16}


from ..utils import env_flag, env_float, env_int  # noqa: F401 — canonical
# impl in the utils leaf module (storage/ imports it too); re-exported
# here because runtime is where knob readers historically find env_int

#: per-query bound on concurrently in-flight datanode RPCs (the pool
#: above bounds the process; this bounds one statement's share)
_DIST_FANOUT = [max(1, env_int("GREPTIME_DIST_FANOUT", 8))]


def dist_fanout() -> int:
    return _DIST_FANOUT[0]


def configure_dist_fanout(n: int) -> None:
    """SET dist_fanout — 1 serializes the scatter (the pre-parallel
    behavior, kept for differential benchmarks and debugging)."""
    with _lock:
        _DIST_FANOUT[0] = max(1, int(n))


def _pool(name: str) -> concurrent.futures.ThreadPoolExecutor:
    with _lock:
        pool = _pools.get(name)
        if pool is None:
            pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=_SIZES[name],
                thread_name_prefix=f"gdb-{name}")
            _pools[name] = pool
        return pool


def bg_runtime() -> concurrent.futures.ThreadPoolExecutor:
    return _pool("bg")


def read_runtime() -> concurrent.futures.ThreadPoolExecutor:
    return _pool("read")


def write_runtime() -> concurrent.futures.ThreadPoolExecutor:
    return _pool("write")


def dist_runtime() -> concurrent.futures.ThreadPoolExecutor:
    return _pool("dist")


def spawn_bg(fn: Callable, *args: object,
             **kwargs: object) -> "concurrent.futures.Future":
    from .telemetry import propagate
    return bg_runtime().submit(propagate(fn), *args, **kwargs)


def spawn_read(fn: Callable, *args: object,
               **kwargs: object) -> "concurrent.futures.Future":
    from .telemetry import propagate
    return read_runtime().submit(propagate(fn), *args, **kwargs)


def spawn_write(fn: Callable, *args: object,
                **kwargs: object) -> "concurrent.futures.Future":
    from .telemetry import propagate
    return write_runtime().submit(propagate(fn), *args, **kwargs)


def new_thread(target: Callable, *, name: Optional[str] = None,
               daemon: bool = True, args: tuple = (),
               propagate_context: bool = True) -> threading.Thread:
    """The one sanctioned way to start a dedicated thread (greptlint
    GL06): the target is wrapped in ``telemetry.propagate()`` so the
    worker inherits the creating thread's span + ExecStats context
    instead of silently detaching from its query. Long-lived accept
    loops pass ``propagate_context=False`` — they outlive any request
    and must NOT pin the creator's trace."""
    if propagate_context:
        from .telemetry import propagate
        target = propagate(target)
    return threading.Thread(target=target, name=name, daemon=daemon,
                            args=args)


def transient_executor(max_workers: int,
                       name: str = "transient"
                       ) -> concurrent.futures.ThreadPoolExecutor:
    """A short-lived PLAIN pool: its ``.submit()`` does NOT carry trace
    context — submit through :func:`spawn_on`, or pre-wrap the callable
    in ``telemetry.propagate()`` (what query/stream_exec does). Prefer
    the named shared runtimes for steady-state work (a transient pool
    per call churns threads)."""
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=max_workers, thread_name_prefix=f"gdb-{name}")


def spawn_on(pool: concurrent.futures.Executor, fn: Callable,
             *args: object, **kwargs: object) -> "concurrent.futures.Future":
    """submit() with telemetry context carried onto the worker."""
    from .telemetry import propagate
    return pool.submit(propagate(fn), *args, **kwargs)


def shutdown_runtimes(wait: bool = True) -> None:
    with _lock:
        pools, _pools_copy = dict(_pools), _pools.clear()
    for pool in pools.values():
        pool.shutdown(wait=wait)


def parallel_map(fn: Callable, items: "Iterable", *, max_workers: int = 8,
                 pool: Optional[concurrent.futures.Executor] = None) -> list:
    """Map fn over items with a thread pool; serial for <=1 item/worker.

    The storage IO fan-outs (SST read/decode, per-bucket SST encode/write)
    share this: parquet + zstd drop the GIL, so concurrent workers overlap
    IO and (de)compression. Pass ``pool`` (e.g. ``dist_runtime()``) to run
    on a shared long-lived executor instead of a transient one —
    ``max_workers`` then bounds this call's in-flight window, not the
    pool."""
    return list(parallel_imap(fn, items, max_workers=max_workers,
                              pool=pool))


def parallel_imap(fn: Callable, items: "Iterable", *,
                  max_workers: int = 8,
                  pool: Optional[concurrent.futures.Executor] = None
                  ) -> Iterator:
    """parallel_map but yielding results in order as they become ready, so
    the consumer can process-and-drop (pipelined gather) instead of
    barriering on the slowest item."""
    items = list(items)
    if len(items) <= 1 or max_workers <= 1:
        for x in items:
            yield fn(x)
        return
    from .telemetry import propagate
    fn = propagate(fn)       # workers stay parented to the caller's trace
    if pool is not None:
        yield from _bounded_ordered(pool, fn, items, max_workers)
        return
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(max_workers, len(items))) as p:
        yield from p.map(fn, items)


def _bounded_ordered(pool: concurrent.futures.Executor, fn: Callable,
                     items, window: int) -> Iterator:
    """Ordered streaming map over a SHARED executor with at most `window`
    items of this call in flight (a transient pool gets the same bound
    from its worker count; a shared pool needs it explicitly, or one
    call could queue its whole fan-out ahead of everyone else's)."""
    from collections import deque
    it = iter(items)
    pending: "deque" = deque()
    for x in it:
        pending.append(pool.submit(fn, x))
        if len(pending) >= window:
            break
    try:
        while pending:
            res = pending.popleft().result()   # oldest first: ordered
            # refill only after the oldest completed, so in-flight never
            # exceeds the window (the others kept running meanwhile)
            for x in it:
                pending.append(pool.submit(fn, x))
                break
            yield res
    finally:
        # abort OR abandoned consumer (GeneratorExit at the yield):
        # cancel what hasn't started — orphaned work must not occupy the
        # SHARED pool's slots after the statement failed (already-running
        # futures finish; their results are dropped)
        for f in pending:
            f.cancel()
