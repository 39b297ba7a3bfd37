"""Background-job visibility: root spans + a live registry.

Counters tell an operator *how many* flushes ran; they cannot answer
"what background work is running RIGHT NOW, on which region, and how
long has it been at it" — the question that matters when a compaction
storm causes p99 pain. Every background entry point (flush, compaction,
TTL/retention sweeps, flow folds, balancer op steps, WAL group-commit
leader flushes) wraps itself in :func:`job`, which

1. opens a **root span** (``telemetry.root_span``) so the work gets its
   own trace id — background work belongs to no statement's trace, and
   with the durable trace store (common/trace_store.py) a slow or
   failed compaction's span history survives into
   ``greptime_private.trace_spans`` exactly like a slow query's;
2. registers a live entry in the process-wide :class:`JobRegistry`
   served by ``information_schema.background_jobs`` (running jobs plus
   the last-N completed with durations and outcomes).

greptlint GL13 enforces the contract statically: a callback handed to
``RepeatedTask``/``LocalScheduler.submit`` must reach a ``job()`` /
``root_span()`` call.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, Iterator, List, Optional

from .locks import TrackedLock
from .tracking import tracked_state

#: completed jobs kept for the view, PER KIND (rings; oldest evicted).
#: Per-kind because the rates differ by orders of magnitude: a WAL
#: group-commit fsync job fires tens to hundreds of times per second
#: under sync ingest and would evict every completed compaction from a
#: shared ring within seconds — exactly when an operator is asking
#: "what did the last compactions cost".
COMPLETED_KEEP_PER_KIND = 32

_lock = TrackedLock("common.background_jobs")
_running: Dict[int, dict] = tracked_state({}, "background_jobs.running")
_completed: Dict[str, List[dict]] = tracked_state(
    {}, "background_jobs.completed")
_next_id = [1]
_node_label = ["standalone"]


def configure_node(label: str) -> None:
    """Name this process in the `node` column of background_jobs (the
    frontends and cmd entry points call it alongside
    process_list.configure_node)."""
    with _lock:
        _node_label[0] = label


def _start(kind: str, table: Optional[str], region: Optional[str],
           trace_id: str, attrs: Dict[str, object]) -> dict:
    entry = {
        "job_id": 0, "kind": kind, "table_name": table, "region": region,
        "node": _node_label[0], "state": "running", "trace_id": trace_id,
        "start_ms": int(time.time() * 1000), "duration_ms": None,
        "error": None,
        "detail": json.dumps(attrs, default=str, separators=(",", ":"))
        if attrs else "",
        "_t0": time.perf_counter(),
        # the running thread, so the stack sampler (common/profiler.py)
        # can attribute that thread's samples to THIS job
        "_thread": threading.get_ident(),
    }
    with _lock:
        entry["job_id"] = _next_id[0]
        _next_id[0] += 1
        _running[entry["job_id"]] = entry
    return entry


def _finish(entry: dict, state: str, error: Optional[str] = None) -> None:
    entry["state"] = state
    entry["error"] = error
    entry["duration_ms"] = round(
        (time.perf_counter() - entry.pop("_t0")) * 1e3, 3)
    with _lock:
        _running.pop(entry["job_id"], None)
        ring = _completed.setdefault(entry["kind"], [])
        ring.append(entry)
        if len(ring) > COMPLETED_KEEP_PER_KIND:
            del ring[:len(ring) - COMPLETED_KEEP_PER_KIND]


@contextlib.contextmanager
def job(kind: str, *, table: Optional[str] = None,
        region: Optional[str] = None, **attrs: object) -> Iterator[dict]:
    """Run one background job under a fresh ROOT span + a registry entry.

    The span detaches from any ambient trace on purpose: a flush
    triggered synchronously by ADMIN FLUSH TABLE is the same work as one
    the write path queued, and both must be findable as their own trace
    (the registry entry records the trace id). The caller's trace
    context is restored on exit."""
    from .telemetry import increment_counter, root_span
    span_attrs = dict(attrs)
    if table is not None:
        span_attrs["table"] = table
    if region is not None:
        span_attrs["region"] = region
    with root_span(f"job_{kind}", **span_attrs) as sp:
        entry = _start(kind, table, region, sp["trace_id"], span_attrs)
        try:
            yield entry
        except BaseException as e:  # greptlint: disable=GL02 — re-raised
            _finish(entry, "failed", f"{type(e).__name__}: {e}")
            increment_counter(f"bg_job_{kind}_failed")
            raise
        else:
            _finish(entry, "done")


def rows() -> List[dict]:
    """Snapshot for information_schema.background_jobs: running jobs
    first (most recent last), then completed newest-first (merged
    across the per-kind rings)."""
    with _lock:
        running = [dict(e) for e in _running.values()]
        done = sorted((dict(e) for ring in _completed.values()
                       for e in ring),
                      key=lambda e: e["job_id"], reverse=True)
    now = time.perf_counter()
    out = []
    for e in running:
        t0 = e.pop("_t0", None)
        e.pop("_thread", None)
        if t0 is not None:
            e["duration_ms"] = round((now - t0) * 1e3, 3)
        out.append(e)
    for e in done:
        e.pop("_t0", None)
        e.pop("_thread", None)
        out.append(e)
    return out


def jobs_by_thread() -> Dict[int, dict]:
    """Snapshot for the stack sampler: which thread runs which
    background job right now (entry dicts, not copies — read-only)."""
    with _lock:
        return {e["_thread"]: e for e in _running.values()
                if "_thread" in e}


def reset() -> None:
    """Test/sqlness hook: forget all history (ids restart)."""
    with _lock:
        _running.clear()
        _completed.clear()
        _next_id[0] = 1
