"""Continuous profiling: an always-on wall-clock stack sampler with
live query/job attribution and in-database retention.

The trace store (common/trace_store.py) answers *where time went
between nodes* and exec stats answer *which stage*; this module answers
*which code*. A daemon thread samples every Python thread's stack via
``sys._current_frames()`` at a low default rate (~19 Hz, the pprof
convention of a prime just under 20), folds each stack into one
semicolon-joined line, and attributes it **at sample time**:

- to the owning statement through the process registry
  (``process_list.entries_by_thread`` — ``track()`` on the frontend
  thread, ``telemetry.propagate`` → ``install()`` on pool workers),
- to background work through the job registry
  (``background_jobs.jobs_by_thread`` — flush/compaction/flow/
  balancer/...); anything else is honest ``idle``,
- to the executing node through :func:`node_context` (the in-process
  datanode client wraps its data-plane calls, so a 4-datanode test
  cluster in ONE process still attributes samples per node).

Aggregated folded stacks flush through the self-monitor ingest path
(``suppress_metrics`` + ``admission.exempt``, like trace spans) into
the auto-created ``greptime_private.profile_samples`` table — profile
history is ordinary data: SQL queries it, retention sweeps it
(``SET profile_retention_ms``), and trace ids join it to
``trace_spans`` so a slow query's flamegraph sits next to its
waterfall. Datanode processes run a writer-less sampler whose rows
ride the Flight ``profile`` action back to the asking frontend.

Knobs (SET name / env twin):
    profiling            GREPTIME_PROFILING            default off
    profile_hz           GREPTIME_PROFILE_HZ           default 19 Hz
    profile_retention_ms GREPTIME_PROFILE_RETENTION_MS default 1d

Ported from greptimedb_tpu/common/profiler.py unchanged in behavior. The
sampler thread (started with the port's `runtime.new_thread`) only walks
``sys._current_frames()`` and the port's process and job registries: this
module imports no torch, so the thread never creates a CUDA context and
never synchronizes the device the sampled statements run on.
`flamegraph_svg`, `folded_text` and `profile_tree_rows` render exactly
what the reference's do on the same rows. The datanode-side halves (the
writer-less sampler, `drain_rows` / `absorb_rows` over the Flight
``profile`` action) are the reference's, and a distributed frontend
drains them (ADMIN SHOW PROFILE, information_schema.profile_samples).
"""

from __future__ import annotations

import contextlib
import logging
import sys
import threading
import time
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from .failpoint import register as _fp_register
from .locks import TrackedLock
from .tracking import tracked_state
from ..utils import env_flag, env_float, env_int

logger = logging.getLogger(__name__)

PRIVATE_SCHEMA = "greptime_private"
PROFILE_SAMPLES_TABLE = "profile_samples"

#: evaluated inside Profiler.flush — a 'panic' spec drops that flush's
#: pending samples (counted on write_errors + dropped), never the host
_fp_register("profiler_flush")

_config_lock = TrackedLock("common.profiler_config")

#: master switch for the continuous sampler (bursts ignore it)
_ENABLED: List[bool] = [env_flag("GREPTIME_PROFILING", False)]
#: continuous sampling rate; 19 Hz = the pprof-style prime just under
#: 20, cheap enough for always-on yet ~1k samples/min of signal
_HZ: List[float] = [env_float("GREPTIME_PROFILE_HZ", 19.0)]
#: retention for greptime_private.profile_samples, ms; 0 disables the
#: sweep. Profiles age faster than traces — default 1d vs traces' 3d.
_RETENTION_MS: List[int] = [env_int("GREPTIME_PROFILE_RETENTION_MS",
                                    24 * 3600 * 1000)]

MIN_HZ, MAX_HZ = 1.0, 250.0


def configure(*, enabled: Optional[bool] = None,
              hz: Optional[float] = None,
              retention_ms: Optional[int] = None) -> None:
    """SET profiling / profile_hz / profile_retention_ms knobs."""
    with _config_lock:
        if enabled is not None:
            _ENABLED[0] = bool(enabled)
        if hz is not None:
            h = float(hz)
            if not MIN_HZ <= h <= MAX_HZ:
                raise ValueError(
                    f"profile_hz must be in [{MIN_HZ:g}, {MAX_HZ:g}]")
            _HZ[0] = h
        if retention_ms is not None:
            _RETENTION_MS[0] = max(0, int(retention_ms))
    s = _SAMPLER[0]
    if s is not None and _ENABLED[0]:
        s.ensure_running()


def enabled() -> bool:
    return _ENABLED[0]


def hz() -> float:
    return _HZ[0]


def retention_ms() -> int:
    return _RETENTION_MS[0]


# ---------------------------------------------------------------------------
# per-thread node attribution (the in-process cluster case)
# ---------------------------------------------------------------------------

_node_lock = TrackedLock("common.profiler_nodes")
#: thread ident -> stack of node labels (LocalDatanodeClient pushes
#: "dn<k>" around its data-plane calls; innermost wins)
_NODE_BY_THREAD: Dict[int, List[str]] = tracked_state(
    {}, "profiler.node_by_thread")


def sampling_active() -> bool:
    """True while samples are actually being taken (knob on, or a burst
    in flight) — the cheap gate for per-call attribution bookkeeping."""
    s = _SAMPLER[0]
    return s is not None and (_ENABLED[0] or s.has_bursts())


@contextlib.contextmanager
def node_context(label: str) -> Iterator[None]:
    """Attribute this thread's samples to `label` (e.g. "dn2") for the
    duration — how in-process datanode work gets per-node flamegraph
    rows. A no-op while nothing samples."""
    if not sampling_active():
        yield
        return
    tid = threading.get_ident()
    with _node_lock:
        _NODE_BY_THREAD.setdefault(tid, []).append(str(label))
    try:
        yield
    finally:
        with _node_lock:
            stack = _NODE_BY_THREAD.get(tid)
            if stack:
                stack.pop()
            if not stack:
                _NODE_BY_THREAD.pop(tid, None)


def node_overrides() -> Dict[int, str]:
    with _node_lock:
        return {t: s[-1] for t, s in _NODE_BY_THREAD.items() if s}


# ---------------------------------------------------------------------------
# stack folding
# ---------------------------------------------------------------------------

MAX_STACK_DEPTH = 64


def _frame_label(code) -> str:
    fn = code.co_filename
    i = fn.rfind("greptimedb_tpu")
    if i >= 0:
        short = fn[i:].replace("\\", "/")
    else:
        short = fn.rsplit("/", 1)[-1].rsplit("\\", 1)[-1]
    return f"{short}:{code.co_name}"


def fold_stack(frame) -> str:
    """One sampled thread stack, root-first, semicolon-joined — the
    Brendan Gregg folded format every flamegraph tool eats."""
    parts: List[str] = []
    while frame is not None and len(parts) < MAX_STACK_DEPTH:
        parts.append(_frame_label(frame.f_code))
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


def stack_id(stack: str) -> str:
    """Stable short id for one folded stack — a tag column, so distinct
    stacks of one (node, kind, id) never collide on the primary key."""
    return format(zlib.crc32(stack.encode()) & 0xFFFFFFFF, "08x")


def _normalize_kind(kind: str) -> str:
    if kind.startswith("balancer"):
        return "balancer"
    if kind.startswith("flow"):
        return "flow"
    return kind


class Profiler:
    """Per-process sampler (one per node; :func:`install` makes it THE
    process sampler).

    writer present  — frontends/standalone: aggregated rows flush into
                      greptime_private.profile_samples locally.
    writer None     — datanodes: rows accumulate bounded in memory and
                      drain over the Flight ``profile`` action.
    """

    #: distinct (node, kind, id, trace_id, stack) keys held between
    #: flushes; beyond this new stacks shed (drop-counted, never blocks)
    MAX_KEYS = 8192
    #: absorbed remote rows awaiting the local write
    MAX_ABSORBED = 16384
    #: poll cadence while the knob is off and no burst runs
    IDLE_POLL_S = 0.25
    #: burst bounds (the HTTP/Flight on-demand surface)
    BURST_MAX_S = 60.0
    BURST_DEFAULT_HZ = 99.0

    def __init__(self, node_label: str = "standalone", writer=None):
        self.node_label = node_label
        #: hosting frontend (handle_row_insert) — None on datanodes
        self.writer = writer
        self._lock = TrackedLock("common.profiler")
        #: (node, kind, id, trace_id, stack) -> sample count
        self._agg: Dict[Tuple[str, str, str, str, str], int] = \
            tracked_state({}, "profiler.agg")
        self._window_start_ms: List[Optional[int]] = tracked_state(
            [None], "profiler.window_start")
        #: remote rows (Flight profile drains) awaiting the local write
        self._absorbed: List[dict] = tracked_state(
            [], "profiler.absorbed")
        #: live burst collectors: {"agg": {...}, "hz": float}
        self._bursts: List[dict] = tracked_state([], "profiler.bursts")
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: wakes the loop out of its idle poll the moment a burst
        #: registers, so a short burst never loses its window to a
        #: stale 250ms sleep
        self._kick = threading.Event()
        #: trace id of the most recently sampled query — what
        #: ADMIN SHOW PROFILE 'last' resolves to
        self.last_query_trace: Optional[str] = None
        self.stats: Dict[str, int] = tracked_state({
            "samples": 0, "dropped": 0, "flushes": 0, "rows_written": 0,
            "write_errors": 0, "overhead_ns": 0, "rows_absorbed": 0,
        }, "profiler.stats")

    # ------------------------------------------------------------------
    # sampler thread lifecycle
    # ------------------------------------------------------------------
    def ensure_running(self) -> None:
        """Start the daemon sampler thread if it isn't running. Lazy on
        purpose: with the knob off (the default) no thread exists at
        all — zero always-on cost until someone asks for profiles."""
        from .runtime import new_thread
        with self._lock:
            t = self._thread
            if t is not None and t.is_alive():
                return
            self._stop = threading.Event()
            self._kick = threading.Event()
            t = new_thread(self._loop,
                           name=f"profiler-{self.node_label}",
                           daemon=True, propagate_context=False)
            self._thread = t
        t.start()

    def stop(self, join: bool = True) -> None:
        with self._lock:
            t, self._thread = self._thread, None
            self._stop.set()
            self._kick.set()
        if t is not None and join:
            t.join(timeout=2)

    def has_bursts(self) -> bool:
        with self._lock:
            return bool(self._bursts)

    def _interval(self) -> float:
        with self._lock:
            rates = [b["hz"] for b in self._bursts]
        if enabled():
            rates.append(hz())
        if not rates:
            return self.IDLE_POLL_S
        return 1.0 / max(rates)

    def _loop(self) -> None:
        stop, kick = self._stop, self._kick
        while True:
            kick.wait(self._interval())
            kick.clear()
            if stop.is_set():
                return
            if enabled() or self.has_bursts():
                self.sample_once()

    # ------------------------------------------------------------------
    # one sampling pass
    # ------------------------------------------------------------------
    def sample_once(self) -> int:
        """Sample every thread's stack once, attribute, aggregate.
        Returns the number of samples taken. Never raises."""
        t0 = time.perf_counter_ns()
        me = threading.get_ident()
        try:
            frames = sys._current_frames()
            from . import background_jobs, process_list
            jobs = background_jobs.jobs_by_thread()
            procs = process_list.entries_by_thread()
            nodes = node_overrides()
            now_ms = int(time.time() * 1000)
            keys: List[Tuple[str, str, str, str, str]] = []
            for tid, frame in frames.items():
                if tid == me:
                    continue
                stack = fold_stack(frame)
                if not stack:
                    continue
                node = nodes.get(tid, self.node_label)
                job = jobs.get(tid)
                if job is not None:
                    kind = _normalize_kind(str(job.get("kind") or ""))
                    ident = str(job.get("job_id") or "")
                    trace = str(job.get("trace_id") or "")
                else:
                    entry = procs.get(tid)
                    if entry is not None:
                        kind = "query"
                        ident = str(entry.id)
                        trace = entry.trace_id or ""
                    else:
                        kind, ident, trace = "idle", "", ""
                keys.append((node, kind, ident, trace, stack))
        except Exception:  # noqa: BLE001 — the sampler must not die
            logger.exception("profiler sampling pass failed")
            return 0
        finally:
            frames = None       # drop frame refs promptly
        dropped = 0
        with self._lock:
            if self._window_start_ms[0] is None:
                self._window_start_ms[0] = now_ms
            for key in keys:
                if key in self._agg:
                    self._agg[key] += 1
                elif len(self._agg) < self.MAX_KEYS:
                    self._agg[key] = 1
                else:
                    dropped += 1
                if key[1] == "query" and key[3]:
                    self.last_query_trace = key[3]
            for b in self._bursts:
                bagg = b["agg"]
                for key in keys:
                    if key in bagg:
                        bagg[key] += 1
                    elif len(bagg) < self.MAX_KEYS:
                        bagg[key] = 1
                    else:
                        dropped += 1
            self.stats["samples"] += len(keys)
            self.stats["dropped"] += dropped
            overhead = time.perf_counter_ns() - t0
            self.stats["overhead_ns"] += overhead
        self._publish(len(keys), dropped, overhead)
        return len(keys)

    def _publish(self, samples: int, dropped: int,
                 overhead_ns: int) -> None:
        """Prometheus counters, outside self._lock (increment_counter
        takes the telemetry metrics lock)."""
        from .telemetry import increment_counter
        if samples:
            increment_counter("profiler_samples", samples)
        if dropped:
            increment_counter("profiler_dropped", dropped)
        if overhead_ns:
            increment_counter("profiler_overhead_ns", overhead_ns)

    # ------------------------------------------------------------------
    # on-demand bursts (GET /debug/prof/cpu, Flight `profile`)
    # ------------------------------------------------------------------
    def collect_burst(self, seconds: float,
                      burst_hz: Optional[float] = None) -> List[dict]:
        """Sample at a high rate for `seconds` on the CALLER's clock
        (the request thread sleeps here) and return that window's rows
        only. Independent of the `profiling` knob; the continuous
        aggregation keeps running untouched."""
        seconds = min(max(float(seconds), 0.05), self.BURST_MAX_S)
        h = float(burst_hz) if burst_hz else self.BURST_DEFAULT_HZ
        h = min(max(h, MIN_HZ), 997.0)
        start_ms = int(time.time() * 1000)
        b = {"agg": {}, "hz": h}
        with self._lock:
            self._bursts.append(b)
        self.ensure_running()
        self._kick.set()     # cut any in-flight idle poll short
        try:
            time.sleep(seconds)
        finally:
            with self._lock:
                if b in self._bursts:
                    self._bursts.remove(b)
        return self._rows_from(list(b["agg"].items()), start_ms)

    # ------------------------------------------------------------------
    # drain / absorb / flush (the write path)
    # ------------------------------------------------------------------
    @staticmethod
    def _rows_from(items, ts_ms: Optional[int]) -> List[dict]:
        ts = int(ts_ms) if ts_ms is not None else int(time.time() * 1000)
        return [{"node": k[0], "kind": k[1], "id": k[2],
                 "trace_id": k[3], "stack_id": stack_id(k[4]),
                 "ts": ts, "stack": k[4], "count": int(c)}
                for k, c in items]

    def drain_rows(self) -> List[dict]:
        """Take the continuous aggregation window as rows (clearing it)
        — what the Flight `profile` action exports from a datanode."""
        with self._lock:
            items = list(self._agg.items())
            self._agg.clear()
            ts0, self._window_start_ms[0] = self._window_start_ms[0], None
        return self._rows_from(items, ts0)

    def absorb_rows(self, rows: List[dict]) -> None:
        """Rows a datanode returned over the wire: queue them for the
        local write (frontend side)."""
        if not rows:
            return
        keys = ("node", "kind", "id", "trace_id", "stack_id", "ts",
                "stack", "count")
        dropped = 0
        with self._lock:
            for r in rows:
                if not isinstance(r, dict) or not r.get("stack"):
                    continue
                if len(self._absorbed) >= self.MAX_ABSORBED:
                    dropped += 1
                    self.stats["dropped"] += 1
                    continue
                self._absorbed.append({k: r.get(k) for k in keys})
                self.stats["rows_absorbed"] += 1
        if dropped:
            from .telemetry import increment_counter
            increment_counter("profiler_dropped", dropped)

    def flush(self) -> int:
        """Write the aggregation window (plus any absorbed remote rows)
        into greptime_private.profile_samples through the hosting
        frontend's normal ingest path, under the recursion guards.
        Returns rows written. Never raises (the profiler must not break
        its host); failed rows are dropped and counted."""
        if self.writer is None:
            return 0
        rows = self.drain_rows()
        with self._lock:
            rows.extend(self._absorbed)
            self._absorbed[:] = []
        if not rows:
            return 0
        from . import admission
        from .failpoint import fail_point
        from .telemetry import increment_counter, suppress_metrics
        from ..datatypes.data_type import INT64, STRING
        from ..session import QueryContext
        now_ms = int(time.time() * 1000)
        for r in rows:
            if not isinstance(r.get("ts"), int):
                r["ts"] = now_ms
        cols = {k: [r.get(k) for r in rows] for k in (
            "node", "kind", "id", "trace_id", "stack_id", "ts",
            "stack", "count")}
        try:
            fail_point("profiler_flush")
            with suppress_metrics(), admission.exempt():
                n = self.writer.handle_row_insert(
                    PROFILE_SAMPLES_TABLE, cols,
                    tag_columns=("node", "kind", "id", "trace_id",
                                 "stack_id"),
                    timestamp_column="ts",
                    types={"node": STRING, "kind": STRING, "id": STRING,
                           "trace_id": STRING, "stack_id": STRING,
                           "stack": STRING, "count": INT64},
                    ctx=QueryContext(current_schema=PRIVATE_SCHEMA))
        except Exception as e:  # noqa: BLE001 — observer must not break
            logger.warning("profile flush failed (%d rows dropped): %s",
                           len(rows), e)
            with self._lock:
                self.stats["write_errors"] += 1
                self.stats["dropped"] += len(rows)
            increment_counter("profiler_dropped", len(rows))
            return 0
        with self._lock:
            self.stats["rows_written"] += n
            self.stats["flushes"] += 1
        return n

    # ------------------------------------------------------------------
    # slow-query annotation
    # ------------------------------------------------------------------
    def top_frames(self, trace_id: str, n: int = 3
                   ) -> List[Tuple[str, int]]:
        """Top-n self-time (leaf) frames of one query's live samples —
        the slow-query log's "why" one-liner. Reads the un-flushed
        aggregation only: it is called the moment the statement closes,
        before any flush could have run."""
        leaf_counts: Dict[str, int] = {}
        with self._lock:
            for (node, kind, ident, trace, stack), c in \
                    self._agg.items():
                if kind != "query" or trace != trace_id:
                    continue
                leaf = stack.rsplit(";", 1)[-1]
                leaf_counts[leaf] = leaf_counts.get(leaf, 0) + c
        return sorted(leaf_counts.items(),
                      key=lambda kv: (-kv[1], kv[0]))[:n]

    def pending_count(self) -> int:
        with self._lock:
            return len(self._agg) + len(self._absorbed)

    def row(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = dict(self.stats)
        out["node"] = self.node_label
        out["enabled"] = enabled()
        out["hz"] = hz()
        out["retention_ms"] = retention_ms()
        return out


# ---------------------------------------------------------------------------
# process-wide sampler
# ---------------------------------------------------------------------------

_SAMPLER: List[Optional[Profiler]] = [None]


def sampler() -> Optional[Profiler]:
    return _SAMPLER[0]


def install(new_sampler: Optional[Profiler]) -> Optional[Profiler]:
    """Make `new_sampler` the process-wide sampler (None uninstalls).
    The previous sampler's thread is stopped so construct-heavy test
    suites never accumulate 19 Hz threads. Returns the previous
    sampler (tests restore it)."""
    with _config_lock:
        old, _SAMPLER[0] = _SAMPLER[0], new_sampler
    if old is not None and old is not new_sampler:
        old.stop(join=False)
    if new_sampler is not None and _ENABLED[0]:
        new_sampler.ensure_running()
    return old


def slow_query_suffix(trace_id: str) -> str:
    """The slow-query WARN's "why" fragment: the query's top-3
    self-time frames, e.g. ` profile_top=[a(12);b(4);c(1)]`. Empty when
    nothing sampled (knob off, or the query too fast to catch)."""
    s = _SAMPLER[0]
    if s is None or not _ENABLED[0]:
        return ""
    top = s.top_frames(trace_id, 3)
    if not top:
        return ""
    return " profile_top=[" + ";".join(
        f"{frame}({c})" for frame, c in top) + "]"


# ---------------------------------------------------------------------------
# folded-output helpers (HTTP burst formats)
# ---------------------------------------------------------------------------

def folded_text(rows: List[dict]) -> str:
    """`stack count` lines, stacks merged across attribution — feedable
    straight into any flamegraph.pl-compatible tool."""
    agg: Dict[str, int] = {}
    for r in rows:
        agg[str(r.get("stack") or "")] = \
            agg.get(str(r.get("stack") or ""), 0) + int(r.get("count") or 0)
    return "\n".join(f"{s} {c}" for s, c in
                     sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))
                     if s) + "\n"


def flamegraph_svg(rows: List[dict], title: str = "cpu") -> str:
    """Self-contained SVG flamegraph (icicle layout, root on top) from
    sample rows — no external tooling needed to look at a burst. Width
    is proportional to total samples; hover shows frame + counts."""
    import html as _html
    root: Dict[str, dict] = {}
    total = 0
    for r in rows:
        stack = str(r.get("stack") or "")
        if not stack:
            continue
        c = int(r.get("count") or 0)
        total += c
        children = root
        for frame in stack.split(";"):
            b = children.get(frame)
            if b is None:
                b = children[frame] = {"total": 0, "children": {}}
            b["total"] += c
            children = b["children"]
    width, row_h = 1200.0, 16
    palette = ("#e5674b", "#e08a3c", "#d9a441", "#c8b04a", "#e07a55")
    rects: List[str] = []
    depth_max = [0]

    def _emit(children: Dict[str, dict], x: float, depth: int) -> None:
        depth_max[0] = max(depth_max[0], depth)
        for frame, b in sorted(children.items(),
                               key=lambda kv: (-kv[1]["total"], kv[0])):
            w = width * b["total"] / total
            if w < 0.5:
                x += w
                continue
            y = depth * row_h
            fill = palette[(hash(frame) & 0x7fffffff) % len(palette)]
            label = _html.escape(frame, quote=True)
            pct = 100.0 * b["total"] / total
            text = ""
            if w > 40:
                shown = _html.escape(
                    frame[-max(3, int(w / 7)):], quote=False)
                text = (f'<text x="{x + 2:.1f}" y="{y + 11}" '
                        f'font-size="10" font-family="monospace">'
                        f'{shown}</text>')
            rects.append(
                f'<g><title>{label} — {b["total"]} samples '
                f'({pct:.1f}%)</title>'
                f'<rect x="{x:.1f}" y="{y}" width="{w:.1f}" '
                f'height="{row_h - 1}" fill="{fill}"/>{text}</g>')
            _emit(b["children"], x, depth + 1)
            x += w

    if total:
        _emit(root, 0.0, 1)
    height = (depth_max[0] + 1) * row_h + 4
    head = (f'<text x="4" y="12" font-size="11" '
            f'font-family="monospace">{_html.escape(title)} — '
            f'{total} samples</text>')
    return (f'<svg xmlns="http://www.w3.org/2000/svg" '
            f'width="{int(width)}" height="{height}" '
            f'style="background:#fff">{head}{"".join(rects)}</svg>\n')


# ---------------------------------------------------------------------------
# top-down tree rendering (ADMIN SHOW PROFILE / HTTP flamegraph)
# ---------------------------------------------------------------------------

def profile_tree_rows(rows: List[dict]) -> List[dict]:
    """Stored sample rows → an indented per-node top-down tree with
    self/total sample counts (heaviest subtree first). One renderer for
    ADMIN SHOW PROFILE on both frontends."""
    by_node: Dict[str, List[dict]] = {}
    for r in rows:
        by_node.setdefault(str(r.get("node") or ""), []).append(r)
    out: List[dict] = []
    for node in sorted(by_node):
        root: Dict[str, dict] = {}

        def _bucket(children: Dict[str, dict], frame: str) -> dict:
            b = children.get(frame)
            if b is None:
                b = children[frame] = {"total": 0, "self": 0,
                                       "children": {}}
            return b

        for r in by_node[node]:
            frames = str(r.get("stack") or "").split(";")
            c = int(r.get("count") or 0)
            children = root
            for i, frame in enumerate(frames):
                b = _bucket(children, frame)
                b["total"] += c
                if i == len(frames) - 1:
                    b["self"] += c
                children = b["children"]

        def _emit(children: Dict[str, dict], depth: int) -> None:
            order = sorted(children.items(),
                           key=lambda kv: (-kv[1]["total"], kv[0]))
            for frame, b in order:
                indent = ("  " * depth + "└─ ") if depth else ""
                out.append({"frame": indent + frame, "node": node,
                            "self_samples": b["self"],
                            "total_samples": b["total"]})
                _emit(b["children"], depth + 1)

        _emit(root, 0)
    return out


# ---------------------------------------------------------------------------
# stored-profile reads (ADMIN SHOW PROFILE / information_schema /
# /v1 surfaces share these)
# ---------------------------------------------------------------------------

def fetch_samples(catalog_manager, *, trace_id: Optional[str] = None,
                  query_id: Optional[str] = None) -> List[dict]:
    """Stored profile rows for one trace or one query id, as plain
    dicts. The tag predicate pushes into scan_batches where the table
    accepts filters; the Python-side re-check keeps correctness on
    tables that ignore it (superset semantics)."""
    from .. import DEFAULT_CATALOG_NAME
    table = catalog_manager.table(DEFAULT_CATALOG_NAME, PRIVATE_SCHEMA,
                                  PROFILE_SAMPLES_TABLE)
    if table is None:
        return []
    from ..sql.ast import BinaryOp, Column, Literal
    if trace_id is not None:
        predicate = BinaryOp("=", Column("trace_id"),
                             Literal(trace_id, "string"))
    else:
        predicate = BinaryOp("=", Column("id"),
                             Literal(str(query_id), "string"))
    try:
        batches = table.scan_batches(filters=[predicate])
    except TypeError:      # virtual/file tables take no filters kwarg
        batches = table.scan_batches()
    rows: List[dict] = []
    for b in batches:
        d = b.to_pydict()
        n = len(d.get("stack_id", []))
        for i in range(n):
            if trace_id is not None:
                if str(d["trace_id"][i]) != trace_id:
                    continue
            elif str(d["id"][i]) != str(query_id) or \
                    str(d["kind"][i]) != "query":
                continue
            rows.append({k: (v.item() if hasattr(v, "item") else v)
                         for k, v in ((c, d[c][i]) for c in d)})
    return rows


def sync_and_fetch(catalog_manager, ident: str,
                   clients=None) -> Tuple[Optional[str], List[dict]]:
    """The ONE render-path sequence behind ADMIN SHOW PROFILE:

    1. resolve 'last' to the most recently sampled query's trace id;
    2. drain every datanode's sampler over the Flight `profile` action
       (absorbed into the local pending set) and flush locally, so the
       stored table is complete at render time;
    3. read rows by trace id (32-hex / anything non-numeric) or by
       query id (numeric — the process-list id the slow-query log and
       SHOW PROCESSLIST print).

    Returns (resolved_ident, rows); (None, []) when 'last' has no
    referent."""
    s = sampler()
    if ident == "last":
        resolved = s.last_query_trace if s is not None else None
        if resolved is None:
            return None, []
        ident = resolved
    if s is not None:
        for client in (clients or ()):
            profile = getattr(client, "profile", None)
            if profile is None:
                continue
            try:
                s.absorb_rows(profile(drain=True))
            except Exception as e:  # noqa: BLE001 — a dead datanode
                logger.debug(       # must not block rendering the rest
                    "profile drain failed: %s", e)
        s.flush()
    if ident.isdigit():
        return ident, fetch_samples(catalog_manager, query_id=ident)
    return ident, fetch_samples(catalog_manager, trace_id=ident)
