"""Durable in-database trace store: tail-sampled span persistence.

Spans used to die as DEBUG log lines or leave the building via OTLP to
a collector nobody runs. This module persists them into the database
they describe — the Dapper-style tail-sampling pattern applied to a
TSDB that can eat its own traces (as the self-monitor does with metrics):

- ``TraceSink`` plugs into ``telemetry.span()`` exit (alongside the
  OTLP exporter) and buffers completed spans **per trace** in a
  bounded, drop-counting buffer.
- Sampling is **tail-based**: the retain/drop verdict happens at trace
  completion (the root span's exit) on the root span's node. A trace is
  retained iff it was slow (the slow-query threshold), errored, was
  cancelled/KILLed, touched a balancer op, or falls in the head-sample
  rate (``SET trace_sample_ratio`` / GREPTIME_TRACE_SAMPLE_RATIO,
  default 0.01 — deterministic per trace id, so every node would agree).
- Retained spans flush through the self-monitor ingest path (under
  ``telemetry.suppress_metrics()`` recursion guards) into the
  auto-created ``greptime_private.trace_spans`` table — history is
  ordinary data: SQL queries it, retention sweeps it
  (``SET trace_retention_ms``, default 3d).
- **Datanodes buffer blind.** A datanode sees only fragments of a trace
  (its ``dn_scan``/``dn_write_region`` spans) and cannot decide; it
  buffers spans keyed by trace_id until the frontend's verdict arrives
  piggybacked on subsequent RPCs (``trace_verdicts`` rides every
  outbound Flight body; retained spans return on the same RPC's
  response), or a TTL evicts them (GREPTIME_TRACE_BUFFER_TTL_S).

Ported from greptimedb_tpu/common/trace_store.py unchanged in behavior:
the sink plugs into the port's own `telemetry.set_span_sink`, and the
tail verdicts, the head-sample hash and the retention sweep are the
reference's. The standalone frontend (frontend/instance.py) installs a
root-role sink; the datanode-side halves (`TRACE_SPANS_WIRE_KEY`,
`absorb_spans`, `apply_verdicts`, `take_export`) come along whole and
wait for the distributed plane, which drives them.
"""

from __future__ import annotations

import json
import logging
import time
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .locks import TrackedLock
# from utils, not runtime: a client that reads the sink (client/flight.py)
# must not import the storage engine, and with it torch, through runtime
from ..utils import env_float, env_int
from .tracking import tracked_state

logger = logging.getLogger(__name__)

PRIVATE_SCHEMA = "greptime_private"
TRACE_SPANS_TABLE = "trace_spans"

#: wire key for buffered spans riding a Flight response (stream schema
#: metadata on do_get; a JSON field on do_put acks / action responses)
TRACE_SPANS_WIRE_KEY = b"gdb.trace_spans"
#: request-body key the frontend's verdicts piggyback on
TRACE_VERDICTS_BODY_KEY = "trace_verdicts"

_config_lock = TrackedLock("common.trace_store_config")

#: head-sample rate for traces with no tail-retention flag (0 = only
#: slow/error/cancelled/balancer traces persist; 1 = everything does)
_SAMPLE_RATIO: List[float] = [env_float("GREPTIME_TRACE_SAMPLE_RATIO",
                                        0.01)]
#: retention for greptime_private.trace_spans, ms; 0 disables the sweep.
#: Traces are bulkier than metrics — default 3d vs the metrics' 7d.
_RETENTION_MS: List[int] = [env_int("GREPTIME_TRACE_RETENTION_MS",
                                    3 * 24 * 3600 * 1000)]
#: datanode-side buffer TTL: spans of a trace whose verdict never
#: arrives (frontend died, no further RPCs) evict after this long
_BUFFER_TTL_S: List[int] = [env_int("GREPTIME_TRACE_BUFFER_TTL_S", 300)]


def configure(*, sample_ratio: Optional[float] = None,
              retention_ms: Optional[int] = None,
              buffer_ttl_s: Optional[int] = None) -> None:
    """SET trace_sample_ratio / trace_retention_ms knobs."""
    with _config_lock:
        if sample_ratio is not None:
            r = float(sample_ratio)
            if not 0.0 <= r <= 1.0:
                raise ValueError("trace_sample_ratio must be in [0, 1]")
            _SAMPLE_RATIO[0] = r
        if retention_ms is not None:
            _RETENTION_MS[0] = max(0, int(retention_ms))
        if buffer_ttl_s is not None:
            _BUFFER_TTL_S[0] = max(1, int(buffer_ttl_s))


def sample_ratio() -> float:
    return _SAMPLE_RATIO[0]


def retention_ms() -> int:
    return _RETENTION_MS[0]


def head_sampled(trace_id: str) -> bool:
    """Deterministic head-sample decision: a pure function of the trace
    id, so any process that re-derived it would agree (and tests can pin
    it with ratio 0/1)."""
    ratio = _SAMPLE_RATIO[0]
    if ratio <= 0.0:
        return False
    if ratio >= 1.0:
        return True
    h = zlib.crc32(trace_id.encode()) & 0xFFFFFFFF
    return h / 2**32 < ratio


class TraceSink:
    """Per-process span sink (one per node; ``install()`` makes it the
    telemetry hook).

    role="root"   — this process decides verdicts (frontends,
                    standalone): a completing span with no parent — or
                    with only a *remote* parent, i.e. an external
                    client's traceparent — completes its trace.
    role="buffer" — this process buffers remote-rooted traces until the
                    verdict arrives over the wire (datanodes); traces
                    genuinely rooted here (background jobs) still get a
                    local verdict, exported on the next RPC response.
    """

    MAX_TRACES = 512
    MAX_SPANS_PER_TRACE = 512
    MAX_PENDING = 8192
    MAX_EXPORT = 4096
    VERDICT_RING = 512
    #: verdicts piggybacked per outbound RPC (most recent first)
    PIGGYBACK_MAX = 32

    def __init__(self, node_label: str = "standalone",
                 service: str = "standalone", role: str = "root",
                 writer=None):
        self.node_label = node_label
        self.service = service
        self.role = role
        #: hosting frontend (handle_row_insert) — None on datanodes
        self.writer = writer
        self._lock = TrackedLock("common.trace_sink")
        #: trace_id -> {"spans": [row...], "flags": set, "t": monotonic}
        self._traces: "OrderedDict[str, dict]" = tracked_state(
            OrderedDict(), "trace_sink.traces")
        #: retained rows awaiting a local write (writer processes)
        self._pending: List[dict] = tracked_state(
            [], "trace_sink.pending")
        #: retained rows awaiting export on an RPC response (datanodes):
        #: (monotonic_t, row)
        self._export: List[Tuple[float, dict]] = tracked_state(
            [], "trace_sink.export")
        #: recent verdicts: trace_id -> (retained, monotonic_t). Late
        #: spans (pool workers finishing after the root) consult this;
        #: outbound RPCs piggyback the youngest entries.
        self._verdicts: "OrderedDict[str, tuple]" = tracked_state(
            OrderedDict(), "trace_sink.verdicts")
        self.last_retained: Optional[str] = None
        #: drops recorded under the lock but not yet published to the
        #: prometheus counter (published outside the lock — the counter
        #: takes the telemetry metrics lock)
        self._uncounted_drops = 0
        #: rate limit for the opportunistic TTL eviction buffer-role
        #: sinks run on their own RPC traffic (no SelfMonitor there)
        self._last_evict = 0.0
        self.stats: Dict[str, int] = tracked_state({
            "spans_recorded": 0, "spans_dropped": 0,
            "traces_retained": 0, "traces_sampled_out": 0,
            "traces_evicted": 0, "rows_written": 0, "write_errors": 0,
            "spans_exported": 0, "spans_absorbed": 0,
        }, "trace_sink.stats")

    # ------------------------------------------------------------------
    # span intake (called from telemetry.span() exit — keep it cheap)
    # ------------------------------------------------------------------
    def on_span_end(self, s: dict, elapsed_ms: float,
                    status: str) -> None:
        from .telemetry import slow_query_threshold_ms
        trace_id = s["trace_id"]
        attrs = s.get("attrs") or {}
        node = attrs.get("node")
        if isinstance(node, int):
            node = f"dn{node}"      # datanode spans attr their node id
        row = {
            "node": str(node) if node is not None else self.node_label,
            "service": self.service,
            "span_name": s["name"],
            "trace_id": trace_id,
            "span_id": s["span_id"],
            "parent_span_id": s.get("parent_id") or "",
            "ts": s.get("start_unix_ns", 0) // 1_000_000,
            "duration_ms": round(elapsed_ms, 3),
            "status": status,
            "attrs": json.dumps(attrs, default=str,
                                separators=(",", ":")) if attrs else "",
        }
        thr = slow_query_threshold_ms()
        flag = None
        if status in ("error", "cancelled"):
            flag = status
        elif thr is not None and elapsed_ms >= thr:
            flag = "slow"
        elif "balancer_op" in s["name"] or "balancer_step" in s["name"]:
            flag = "balancer"
        is_root = s.get("parent_id") is None or \
            (s.get("remote_parent") and self.role == "root")
        with self._lock:
            self.stats["spans_recorded"] += 1
            verdict = self._verdicts.get(trace_id)
            if verdict is not None:
                # late span of an already-decided trace (pool worker
                # finishing after the root): apply the verdict directly
                if verdict[0]:
                    self._stash(row)
            else:
                ent = self._traces.get(trace_id)
                if ent is None:
                    if len(self._traces) >= self.MAX_TRACES:
                        self._note_drop()
                    else:
                        ent = self._traces[trace_id] = {
                            "spans": [], "flags": set(),
                            "t": time.monotonic()}
                if ent is not None:
                    if len(ent["spans"]) >= self.MAX_SPANS_PER_TRACE:
                        self._note_drop()
                    else:
                        ent["spans"].append(row)
                    if flag:
                        ent["flags"].add(flag)
                if is_root:
                    self._decide(trace_id)
        self._publish_drops()
        if self.writer is None:
            # buffer-role processes have no SelfMonitor tick: TTL
            # eviction rides their own span traffic (rate-limited)
            self.maybe_evict()

    def _note_drop(self, n: int = 1) -> None:
        """Record n shed spans. Caller holds the lock; the prometheus
        counter is published by _publish_drops OUTSIDE it."""
        self.stats["spans_dropped"] += n
        self._uncounted_drops += n

    def _publish_drops(self) -> None:
        from .telemetry import increment_counter
        with self._lock:
            n, self._uncounted_drops = self._uncounted_drops, 0
        if n:
            increment_counter("trace_sink_dropped", n)

    def _stash(self, row: dict) -> None:
        """Queue one retained row for write (or wire export). Caller
        holds the lock."""
        if self.writer is not None:
            if len(self._pending) >= self.MAX_PENDING:
                self._note_drop()
                return
            self._pending.append(row)
        else:
            if len(self._export) >= self.MAX_EXPORT:
                del self._export[0]
                self._note_drop()
            self._export.append((time.monotonic(), row))

    def _decide(self, trace_id: str) -> None:
        """Tail verdict at trace completion. Caller holds the lock."""
        ent = self._traces.pop(trace_id, None)
        flags = ent["flags"] if ent is not None else set()
        retained = bool(flags) or head_sampled(trace_id)
        self._verdicts[trace_id] = (retained, time.monotonic())
        while len(self._verdicts) > self.VERDICT_RING:
            self._verdicts.popitem(last=False)
        if retained:
            self.stats["traces_retained"] += 1
            self.last_retained = trace_id
            for row in (ent["spans"] if ent is not None else []):
                self._stash(row)
        else:
            self.stats["traces_sampled_out"] += 1

    # ------------------------------------------------------------------
    # slow-query log annotation
    # ------------------------------------------------------------------
    def stored_verdict(self, trace_id: str) -> str:
        """'yes' / 'sampled-out' for the slow-query log line. Callable
        mid-trace: the retention flags accumulate per span and the
        head-sample decision is deterministic, so the answer is already
        known when the statement's span closes."""
        with self._lock:
            v = self._verdicts.get(trace_id)
            if v is not None:
                return "yes" if v[0] else "sampled-out"
            ent = self._traces.get(trace_id)
            if ent is not None and ent["flags"]:
                return "yes"
        return "yes" if head_sampled(trace_id) else "sampled-out"

    # ------------------------------------------------------------------
    # verdict piggyback (the frontend side)
    # ------------------------------------------------------------------
    def recent_verdicts(self) -> Dict[str, bool]:
        """Youngest verdicts to ride an outbound RPC body. Idempotent on
        the receiving datanode (applying twice is a no-op), so the same
        verdict repeats until it ages out of the ring."""
        ttl = _BUFFER_TTL_S[0]
        now = time.monotonic()
        out: Dict[str, bool] = {}
        with self._lock:
            for tid in reversed(self._verdicts):
                retained, t = self._verdicts[tid]
                if now - t > ttl:
                    break
                out[tid] = retained
                if len(out) >= self.PIGGYBACK_MAX:
                    break
        return out

    def push_verdict(self, trace_id: str, retained: bool = True) -> bool:
        """Re-announce a verdict as the YOUNGEST ring entry so the next
        RPC's piggyback window is guaranteed to carry it. The render
        path (ADMIN SHOW TRACE / /v1/trace) calls this — with stored
        rows as its evidence of retention — for the trace it is about
        to ping for: a verdict that aged out of the PIGGYBACK_MAX
        window minutes ago would otherwise never reach a datanode that
        received no RPC in that window, and its buffered spans would
        sit until TTL eviction — the waterfall would silently render
        without them. A trace the ring remembers as sampled-out is NOT
        resurrected (returns False)."""
        with self._lock:
            v = self._verdicts.get(trace_id)
            if v is not None and not v[0]:
                return False
            self._verdicts[trace_id] = (bool(retained), time.monotonic())
            self._verdicts.move_to_end(trace_id)
            while len(self._verdicts) > self.VERDICT_RING:
                self._verdicts.popitem(last=False)
        return True

    def known_verdict(self, trace_id: str) -> Optional[bool]:
        """The ring's memory of a trace's verdict, or None once it has
        aged out."""
        with self._lock:
            v = self._verdicts.get(trace_id)
        return None if v is None else bool(v[0])

    def absorb_spans(self, rows: List[dict]) -> None:
        """Spans a datanode returned on an RPC response: queue them for
        the local write (frontend side)."""
        if not rows:
            return
        keys = ("node", "service", "span_name", "trace_id", "span_id",
                "parent_span_id", "ts", "duration_ms", "status", "attrs")
        with self._lock:
            for r in rows:
                if not isinstance(r, dict) or "trace_id" not in r:
                    continue
                self._stash({k: r.get(k) for k in keys})
                self.stats["spans_absorbed"] += 1
        self._publish_drops()

    # ------------------------------------------------------------------
    # the datanode side
    # ------------------------------------------------------------------
    def apply_verdicts(self, verdicts: Dict[str, bool]) -> None:
        """Verdicts that arrived piggybacked on an inbound RPC: release
        (or discard) the matching buffered traces."""
        if not verdicts:
            return
        with self._lock:
            for tid, retained in verdicts.items():
                ent = self._traces.pop(tid, None)
                if ent is None:
                    continue
                if retained:
                    self.stats["traces_retained"] += 1
                    for row in ent["spans"]:
                        self._stash(row)
                else:
                    self.stats["traces_sampled_out"] += 1

    def take_export(self, limit: int = 512) -> List[dict]:
        """Drain retained spans awaiting export (they ride the RPC
        response back to the asking frontend)."""
        with self._lock:
            if not self._export:
                return []
            taken = self._export[:limit]
            del self._export[:limit]
            self.stats["spans_exported"] += len(taken)
            return [row for _, row in taken]

    def evict_expired(self, now: Optional[float] = None) -> int:
        """TTL eviction: traces whose verdict never arrived, and export
        rows nobody asked for. Every shed span counts on the drop
        metric."""
        ttl = _BUFFER_TTL_S[0]
        now = time.monotonic() if now is None else now
        evicted = 0
        with self._lock:
            for tid in [t for t, e in self._traces.items()
                        if now - e["t"] > ttl]:
                ent = self._traces.pop(tid, None)
                if ent is not None:
                    self._note_drop(len(ent["spans"]))
                evicted += 1
            if evicted:
                self.stats["traces_evicted"] += evicted
            keep = [(t, r) for t, r in self._export if now - t <= ttl]
            dropped = len(self._export) - len(keep)
            if dropped:
                self._export[:] = keep
                self._note_drop(dropped)
        self._publish_drops()
        return evicted

    #: opportunistic-eviction cadence for buffer-role sinks (seconds)
    EVICT_EVERY_S = 5.0

    def maybe_evict(self, now: Optional[float] = None) -> None:
        """Rate-limited evict_expired for processes with no
        SelfMonitor tick (datanodes, metasrv): rides their own span /
        RPC traffic so verdictless buffers cannot pin MAX_TRACES
        forever after a frontend restart loses its verdict ring."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if now - self._last_evict < self.EVICT_EVERY_S:
                return
            self._last_evict = now
        self.evict_expired(now)

    # ------------------------------------------------------------------
    # the write (self-monitor ingest path)
    # ------------------------------------------------------------------
    def flush(self) -> int:
        """Write pending retained spans into
        greptime_private.trace_spans through the hosting frontend's
        normal ingest path, under the recursion guards. Returns rows
        written. Never raises (the trace store must not break its
        host); failed rows are dropped and counted."""
        if self.writer is None:
            return 0
        with self._lock:
            rows, self._pending[:] = list(self._pending), []
        if not rows:
            return 0
        from . import admission
        from .telemetry import suppress_metrics
        from ..datatypes.data_type import FLOAT64, STRING
        from ..session import QueryContext
        cols = {k: [r.get(k) for r in rows] for k in (
            "node", "service", "span_name", "trace_id", "span_id",
            "parent_span_id", "ts", "duration_ms", "status", "attrs")}
        try:
            with suppress_metrics(), admission.exempt():
                n = self.writer.handle_row_insert(
                    TRACE_SPANS_TABLE, cols,
                    tag_columns=("node", "service", "span_name",
                                 "trace_id", "span_id"),
                    timestamp_column="ts",
                    types={"node": STRING, "service": STRING,
                           "span_name": STRING, "trace_id": STRING,
                           "span_id": STRING, "parent_span_id": STRING,
                           "duration_ms": FLOAT64, "status": STRING,
                           "attrs": STRING},
                    ctx=QueryContext(current_schema=PRIVATE_SCHEMA))
        except Exception as e:  # noqa: BLE001 — observer must not break
            logger.warning("trace flush failed (%d spans dropped): %s",
                           len(rows), e)
            with self._lock:
                self.stats["write_errors"] += 1
                self._note_drop(len(rows))
            self._publish_drops()
            return 0
        with self._lock:
            self.stats["rows_written"] += n
        return n

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def buffered_trace_count(self) -> int:
        with self._lock:
            return len(self._traces)

    def row(self) -> Dict[str, object]:
        with self._lock:
            out = dict(self.stats)
        out["node"] = self.node_label
        out["role"] = self.role
        out["sample_ratio"] = sample_ratio()
        out["retention_ms"] = retention_ms()
        return out


# ---------------------------------------------------------------------------
# process-wide sink
# ---------------------------------------------------------------------------

_SINK: List[Optional[TraceSink]] = [None]


def sink() -> Optional[TraceSink]:
    return _SINK[0]


def install(new_sink: Optional[TraceSink]) -> Optional[TraceSink]:
    """Make `new_sink` the process-wide sink telemetry.span() feeds
    (None uninstalls). Returns the previous sink (tests restore it)."""
    from . import telemetry
    with _config_lock:
        old, _SINK[0] = _SINK[0], new_sink
        telemetry.set_span_sink(new_sink)
    return old


# ---------------------------------------------------------------------------
# waterfall reassembly (ADMIN SHOW TRACE / /v1/trace/<id> /
# information_schema share one renderer)
# ---------------------------------------------------------------------------

def waterfall_rows(span_rows: List[dict]) -> List[dict]:
    """Reassemble stored span rows into the indented per-node tree:
    depth-first, children ordered by start ts, with self-time vs
    child-time split. `dist_rpc` spans' self-time is the network share
    (RPC wall minus the datanode-side span) — the node_ms/network_ms
    split the EXPLAIN ANALYZE node blocks compute."""
    by_id: Dict[str, dict] = {}
    for r in span_rows:
        if r.get("span_id"):
            by_id[str(r["span_id"])] = r
    children: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for r in span_rows:
        parent = str(r.get("parent_span_id") or "")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(r)
        else:
            roots.append(r)
    for lst in children.values():
        lst.sort(key=lambda r: (r.get("ts") or 0, str(r.get("span_id"))))
    roots.sort(key=lambda r: (r.get("ts") or 0, str(r.get("span_id"))))
    t0 = min((r.get("ts") or 0) for r in span_rows) if span_rows else 0
    out: List[dict] = []

    def emit(r: dict, depth: int) -> None:
        kids = children.get(str(r.get("span_id")), [])
        dur = float(r.get("duration_ms") or 0.0)
        child_ms = sum(float(k.get("duration_ms") or 0.0) for k in kids)
        self_ms = max(0.0, dur - child_ms)
        name = str(r.get("span_name"))
        indent = ("  " * depth + "└─ ") if depth else ""
        detail = str(r.get("attrs") or "")
        if name == "dist_rpc" and kids:
            detail = (f"network_ms={self_ms:.1f} " + detail).strip()
        out.append({
            "span": indent + name,
            "node": r.get("node"),
            "start_offset_ms": int((r.get("ts") or 0) - t0),
            "duration_ms": round(dur, 3),
            "self_ms": round(self_ms, 3),
            "status": r.get("status"),
            "detail": detail,
        })
        for k in kids:
            emit(k, depth + 1)

    for r in roots:
        emit(r, 0)
    return out


def fetch_trace(catalog_manager, trace_id: str) -> List[dict]:
    """All stored span rows of one trace, as plain dicts (the
    greptime_private.trace_spans scan every surface shares). The
    trace_id tag predicate is pushed into scan_batches when the table
    accepts filters (mito does — the SST secondary indexes then prune
    SSTs for the point lookup); the Python-side re-check
    keeps correctness on tables that ignore it (superset semantics)."""
    from .. import DEFAULT_CATALOG_NAME
    table = catalog_manager.table(DEFAULT_CATALOG_NAME, PRIVATE_SCHEMA,
                                  TRACE_SPANS_TABLE)
    if table is None:
        return []
    from ..sql.ast import BinaryOp, Column, Literal
    predicate = BinaryOp("=", Column("trace_id"),
                         Literal(trace_id, "string"))
    try:
        batches = table.scan_batches(filters=[predicate])
    except TypeError:      # virtual/file tables take no filters kwarg
        batches = table.scan_batches()
    rows: List[dict] = []
    for b in batches:
        d = b.to_pydict()
        n = len(d.get("trace_id", []))
        for i in range(n):
            if str(d["trace_id"][i]) != trace_id:
                continue
            # numpy scalars → natives (these rows go straight to JSON)
            rows.append({k: (v.item() if hasattr(v, "item") else v)
                         for k, v in ((c, d[c][i]) for c in d)})
    return rows


def sync_and_fetch(catalog_manager, trace_id: str,
                   clients=None) -> Tuple[Optional[str], List[dict]]:
    """The ONE render-path sequence behind ADMIN SHOW TRACE and
    GET /v1/trace/<id> (two surfaces, one behavior):

    1. resolve 'last' to the most recently retained trace id;
    2. read the stored rows — they (or a live ring verdict) are the
       EVIDENCE the trace was retained: an id the ring has forgotten
       AND storage has never seen is not resurrected into datanode
       buffers (a sampled-out trace must stay sampled out);
    3. given evidence, re-announce the verdict (push_verdict) so the
       pings' piggyback definitely carries it however long ago it was
       decided, ping each datanode (the ordinary RPC piggyback
       releases any spans still buffered for this trace onto the
       response), flush the sink, and re-read.

    Returns (resolved_trace_id, rows); (None, []) when 'last' has no
    referent, (tid, []) when the trace was never stored."""
    s = sink()
    if trace_id == "last":
        resolved = s.last_retained if s is not None else None
        if resolved is None:
            return None, []
        trace_id = resolved
    if s is not None:
        s.flush()              # this frontend's own pending spans first
    rows = fetch_trace(catalog_manager, trace_id)
    retained = bool(rows) or (s is not None
                              and s.known_verdict(trace_id) is True)
    if not retained or s is None:
        return trace_id, rows
    s.push_verdict(trace_id)
    for client in (clients or ()):
        ping = getattr(client, "ping", None)
        if ping is None:
            continue
        try:
            ping()
        except Exception as e:  # noqa: BLE001 — a dead datanode must
            logger.debug(       # not block rendering what we do have
                "trace span-sync ping failed: %s", e)
    if s.flush() == 0 and not clients:
        return trace_id, rows               # nothing new arrived
    return trace_id, fetch_trace(catalog_manager, trace_id)
