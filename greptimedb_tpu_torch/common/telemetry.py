"""Telemetry: logging init, tracing spans, timer metrics.

Reference behavior: src/common/telemetry — tracing-subscriber logging
with rolling files + env filter (logging.rs:83-150), `timer!` macros
feeding the metrics recorder (metric.rs, macros.rs), and a panic hook.
Python twin:

- `init_logging(level, dir)` — console + size-rotated file handlers.
- `span(name, **attrs)` — nested tracing spans carried in a thread-local
  (trace_id/span_id/parent), logged on exit with duration; the active
  trace context rides log records via a logging.Filter;
  `child_span(name)` opens one only inside a local span's trace.
- `current_traceparent()` / `remote_context(header)` — W3C-traceparent
  wire propagation: every cross-process RPC (Flight scan/moments/write,
  SQL-over-Flight, meta actions, HTTP `traceparent` header) carries the
  caller's trace context, and the receiving process installs it so its
  spans JOIN the caller's trace instead of minting a fresh one. One
  statement = one trace id across frontend, datanodes and meta.
- `propagate(fn)` — capture the caller's span stack at submit time and
  re-install it around `fn` in whatever worker thread runs it, so spans
  opened on the `common/runtime` pools stay parented to the trace.
- `timer(name)` — histogram observation (prometheus_client, in the
  port's own `CollectorRegistry`, `registry()`: the reference registers
  the same `greptime_*` names in prometheus_client's default REGISTRY,
  and both packages run in one process in the differential tests).
- `slow_query_threshold_ms()` — the SET/env-configurable threshold the
  frontend checks per statement (None = slow-query log off).
- `install_panic_hook()` — top-level excepthook that logs crashes.
"""

from __future__ import annotations

import contextlib
import logging
import logging.handlers
import os
import sys
import threading
import time
import uuid
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

logger = logging.getLogger(__name__)

_tls = threading.local()


# ---------------------------------------------------------------------------
# logging init (reference: logging.rs init w/ rolling appenders)
# ---------------------------------------------------------------------------

_FORMAT = ("%(asctime)s %(levelname)s %(name)s "
           "[%(trace_id)s/%(span_id)s] %(message)s")


class _TraceContextFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        span = current_span()
        record.trace_id = span["trace_id"] if span else "-"
        record.span_id = span["span_id"] if span else "-"
        return True


def init_logging(level: str = "info", log_dir: Optional[str] = None,
                 max_bytes: int = 64 * 1024 * 1024,
                 backups: int = 4) -> None:
    root = logging.getLogger()
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    for h in list(root.handlers):
        root.removeHandler(h)
    handlers = [logging.StreamHandler()]
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, "greptimedb.log"),
            maxBytes=max_bytes, backupCount=backups))
    for h in handlers:
        h.setFormatter(logging.Formatter(_FORMAT))
        h.addFilter(_TraceContextFilter())
        root.addHandler(h)


def install_panic_hook() -> None:
    """Log uncaught exceptions before dying (reference: panic_hook.rs)."""
    prev = sys.excepthook

    def hook(exc_type: type, exc: BaseException, tb: object) -> None:
        logging.getLogger("panic").critical(
            "uncaught exception", exc_info=(exc_type, exc, tb))
        prev(exc_type, exc, tb)

    sys.excepthook = hook


# ---------------------------------------------------------------------------
# tracing spans
# ---------------------------------------------------------------------------

def current_span() -> Optional[Dict]:
    stack = getattr(_tls, "spans", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def span(name: str, **attrs: object) -> Iterator[Dict]:
    """Nested span: inherits trace_id from the parent, logs duration on
    exit at DEBUG, and (when configured) ships to an OTLP collector and
    hands itself to the span sink. On exit the span's dict carries its
    `elapsed_ms`; attributes set into its `attrs` before exit travel with
    it. A span observes no histogram: `timer()` is the metric."""
    stack = getattr(_tls, "spans", None)
    if stack is None:
        stack = _tls.spans = []
    parent = stack[-1] if stack else None
    # full 16-byte trace / 8-byte span ids: they travel verbatim in W3C
    # traceparent headers, so both processes log the SAME hex string
    s = {
        "name": name,
        "trace_id": parent["trace_id"] if parent else uuid.uuid4().hex,
        "span_id": uuid.uuid4().hex[:16],
        "parent_id": parent["span_id"] if parent else None,
        # a parent installed by remote_context() means the trace ROOT
        # lives in another process — the trace sink's tail-sampling
        # verdict logic keys off this (a frontend decides for traces an
        # external client rooted; a datanode buffers them)
        "remote_parent": bool(parent
                              and (parent.get("attrs") or {}).get("remote")),
        "attrs": attrs,
        "start": time.perf_counter(),
        "start_unix_ns": time.time_ns(),
    }
    stack.append(s)
    status = "ok"
    try:
        yield s
    except BaseException as e:  # greptlint: disable=GL02 — classified,
        status = _exc_status(e)  # re-raised untouched
        raise
    finally:
        stack.pop()
        elapsed_ms = s["elapsed_ms"] = \
            (time.perf_counter() - s["start"]) * 1e3
        logger.debug("span %s finished in %.2fms attrs=%s", name,
                     elapsed_ms, attrs)
        if not metrics_suppressed():
            exporter = _OTLP[0]
            if exporter is not None:
                exporter.enqueue(s, int(elapsed_ms * 1e6))
            sink = _SPAN_SINK[0]
            if sink is not None:
                try:
                    sink.on_span_end(s, elapsed_ms, status)
                except Exception:  # noqa: BLE001 — the sink must never
                    logger.exception(    # break the traced path
                        "trace sink rejected span %s", name)


@contextlib.contextmanager
def child_span(name: str, **attrs: object) -> Iterator[Optional[Dict]]:
    """A span that only joins a trace which a span of this process holds
    open; elsewhere it yields None and records nothing. For work that
    runs before or after the span that owns its trace (a statement's
    parse, an answer's lazy encode): opened bare it would root a trace
    of its own, and under a remote caller's context alone it would
    complete that caller's trace early."""
    parent = current_span()
    if parent is None or (parent.get("attrs") or {}).get("remote"):
        yield None
        return
    with span(name, **attrs) as s:
        yield s


def _exc_status(e: BaseException) -> str:
    """Span status for an exception crossing the span boundary: KILLed
    statements read as 'cancelled' (they are tail-retained like errors,
    but an operator filters them apart)."""
    from ..errors import QueryCancelledError
    return "cancelled" if isinstance(e, QueryCancelledError) else "error"


@contextlib.contextmanager
def root_span(name: str, **attrs: object) -> Iterator[Dict]:
    """Open a span that ROOTS a fresh trace regardless of the ambient
    context, restoring the caller's stack afterward. Background jobs
    (flush, compaction, flow folds, balancer steps) use this: the work
    belongs to no statement's trace, and rooting it makes the trace
    sink's tail verdict fire at ITS completion."""
    prev = getattr(_tls, "spans", None)
    _tls.spans = []
    try:
        with span(name, **attrs) as s:
            yield s
    finally:
        _tls.spans = prev if prev is not None else []


#: pluggable span sink (common/trace_store.TraceSink): completed spans
#: feed the tail-sampled durable trace store, alongside the OTLP export
_SPAN_SINK: list = [None]


def set_span_sink(sink) -> None:
    with _metrics_lock:
        _SPAN_SINK[0] = sink


def propagate(fn: Callable) -> Callable:
    """Capture the calling thread's span stack NOW and return a callable
    that re-installs it around `fn` wherever it runs.

    `_tls.spans` is thread-local, so a stage submitted to a worker pool
    detaches from its parent trace: spans it opens start a fresh
    trace_id and the OTLP export shows them orphaned. Wrapping the
    submitted callable fixes that — the capture happens at submit (the
    moment the parent span is live), not at execution. The parent span
    dicts are shared read-only; the worker appends to its own list, so
    concurrent workers never see each other's nesting.

    The active ExecStats collector (common/exec_stats.py) rides along
    for the same reason: per-stage EXPLAIN ANALYZE counters recorded by
    pool workers (SST reads, slice decodes) land on the query's
    collector instead of vanishing. ExecStats methods are lock-guarded,
    so concurrent workers may share one collector.

    The active process-list entry (common/process_list.py) and the
    metric-suppression flag travel too: a KILL must be observable from
    a prefetch worker's cancellation check, and the self-monitoring
    scraper's pooled writes must stay excluded from the counters it
    scrapes."""
    from . import exec_stats as _es
    from . import process_list as _pl
    stack = getattr(_tls, "spans", None)
    stats = _es.current()
    entry = _pl.current()
    suppressed = metrics_suppressed()
    if not stack and stats is None and entry is None and not suppressed:
        return fn
    captured = list(stack) if stack else []
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):  # type: ignore[no-untyped-def]
        prev = getattr(_tls, "spans", None)
        prev_sup = getattr(_tls, "suppress_metrics", False)
        _tls.spans = list(captured)
        _tls.suppress_metrics = suppressed
        with _es.collect_into(stats), _pl.install(entry):
            try:
                return fn(*args, **kwargs)
            finally:
                _tls.spans = prev if prev is not None else []
                _tls.suppress_metrics = prev_sup
    return wrapped


# ---------------------------------------------------------------------------
# wire trace propagation (W3C traceparent: 00-<trace>-<span>-<flags>)
# ---------------------------------------------------------------------------

def current_traceparent() -> Optional[str]:
    """W3C traceparent header for the active span, or None outside a
    trace. Attach this to every outbound RPC (Flight ticket / action
    body / do_put command, HTTP header) so the receiving process joins
    this trace."""
    s = current_span()
    if s is None:
        return None
    trace = s["trace_id"][:32].ljust(32, "0")
    span_id = s["span_id"][:16].ljust(16, "0")
    return f"00-{trace}-{span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[tuple]:
    """(trace_id, parent_span_id) from a traceparent header; None when
    absent or malformed (propagation is advisory — a bad header must
    never fail a request)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or len(trace) != 32 or len(span_id) != 16 \
            or len(flags) != 2:
        return None
    try:
        int(version, 16), int(trace, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    # W3C: version 0xff is forbidden; version 00 has exactly 4 fields
    # (higher versions may append more — parse their known prefix);
    # all-zero trace/parent ids are invalid and must be treated as absent
    if version.lower() == "ff" or (version == "00" and len(parts) != 4) \
            or int(trace, 16) == 0 or int(span_id, 16) == 0:
        return None
    return trace, span_id


@contextlib.contextmanager
def remote_context(traceparent: Optional[str]) -> Iterator[Optional[Dict]]:
    """Install a remote caller's trace context on this thread for the
    duration: spans opened underneath inherit the remote trace_id and
    parent onto the caller's span, and log records carry the shared
    trace id. A missing/malformed header is a no-op (fresh trace)."""
    parsed = parse_traceparent(traceparent)
    if parsed is None:
        yield None
        return
    trace_id, span_id = parsed
    stack = getattr(_tls, "spans", None)
    if stack is None:
        stack = _tls.spans = []
    frame = {
        "name": "remote",
        "trace_id": trace_id,
        "span_id": span_id,
        "parent_id": None,
        "attrs": {"remote": True},
        "start": time.perf_counter(),
        "start_unix_ns": time.time_ns(),
    }
    stack.append(frame)
    try:
        yield frame
    finally:
        if stack and stack[-1] is frame:
            stack.pop()
        elif frame in stack:          # defensive: unbalanced nesting
            stack.remove(frame)


# ---------------------------------------------------------------------------
# slow-query log threshold (reference: the slow-query timer in
# src/common/telemetry logging options — statements slower than the
# threshold log at WARN with their trace id and stage stats)
# ---------------------------------------------------------------------------

def _env_slow_query_ms() -> Optional[int]:
    raw = os.environ.get("GREPTIME_SLOW_QUERY_MS")
    if not raw:
        return None
    try:
        v = int(raw)
    except ValueError:
        return None
    return v if v > 0 else None


_SLOW_QUERY_MS: list = [_env_slow_query_ms()]


def slow_query_threshold_ms() -> Optional[int]:
    """Current slow-query threshold in ms; None = disabled (default,
    unless the GREPTIME_SLOW_QUERY_MS env/config set one)."""
    return _SLOW_QUERY_MS[0]


def set_slow_query_threshold_ms(value: Optional[int]) -> None:
    """SET slow_query_threshold_ms — 0 or negative disables."""
    if value is not None and value <= 0:
        value = None
    with _metrics_lock:
        _SLOW_QUERY_MS[0] = value


# ---------------------------------------------------------------------------
# OTLP trace export (reference: the OpenTelemetry pipeline wired in
# src/common/telemetry/src/logging.rs:83-150 — tracing-opentelemetry
# layer + otlp exporter behind config)
# ---------------------------------------------------------------------------

_OTLP: list = [None]


class OtlpExporter:
    """Background OTLP/HTTP-JSON span exporter: bounded queue, batched
    POSTs to `{endpoint}/v1/traces`, dropped (and counted) rather than
    ever blocking the traced path."""

    def __init__(self, endpoint: str, service_name: str = "greptimedb",
                 flush_interval: float = 2.0, max_queue: int = 4096):
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self.flush_interval = flush_interval
        self.max_queue = max_queue
        self.dropped = 0
        self.exported = 0
        self._buf: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="otlp-exporter")
        self._thread.start()

    def enqueue(self, s: Dict, duration_ns: int) -> None:
        start_ns = s.get("start_unix_ns") or time.time_ns()
        rec = {
            # OTLP requires 16-byte trace / 8-byte span ids (hex)
            "traceId": s["trace_id"].ljust(32, "0"),
            "spanId": s["span_id"].ljust(16, "0"),
            "name": s["name"],
            "kind": 1,                            # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(start_ns + duration_ns),
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in (s.get("attrs") or {}).items()],
        }
        if s.get("parent_id"):
            rec["parentSpanId"] = s["parent_id"].ljust(16, "0")
        with self._lock:
            if len(self._buf) >= self.max_queue:
                self.dropped += 1
                full = True
            else:
                self._buf.append(rec)
                full = False
        if full:
            # beyond the one-shot debug log: a silently-shedding exporter
            # must be visible in runtime_metrics / the scrape tables
            increment_counter("trace_export_dropped")

    def _run(self) -> None:
        while not self._stop.wait(self.flush_interval):
            self.flush()
        self.flush()

    def flush(self) -> None:
        with self._lock:
            batch, self._buf = self._buf, []
        if not batch:
            return
        import json as _json
        import urllib.request
        doc = {"resourceSpans": [{
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": self.service_name}}]},
            "scopeSpans": [{
                "scope": {"name": "greptimedb_tpu_torch"},
                "spans": batch,
            }],
        }]}
        req = urllib.request.Request(
            self.endpoint + "/v1/traces",
            data=_json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=5):
                pass
            self.exported += len(batch)
        except Exception as e:  # noqa: BLE001 — export must never break
            self.dropped += len(batch)
            increment_counter("trace_export_dropped", len(batch))
            logger.debug("otlp export failed: %s", e)

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def configure_otlp(endpoint: Optional[str],
                   service_name: str = "greptimedb",
                   flush_interval: float = 2.0) -> Optional[OtlpExporter]:
    """Enable (or, with endpoint=None, disable) OTLP span export."""
    with _metrics_lock:
        old, _OTLP[0] = _OTLP[0], None
    if old is not None:
        old.shutdown()        # flushes over the network: outside the lock
    exporter = None
    if endpoint:
        exporter = OtlpExporter(endpoint, service_name=service_name,
                                flush_interval=flush_interval)
        with _metrics_lock:
            _OTLP[0] = exporter
    return exporter


# ---------------------------------------------------------------------------
# metric suppression (self-monitoring recursion guard)
# ---------------------------------------------------------------------------

def metrics_suppressed() -> bool:
    return getattr(_tls, "suppress_metrics", False)


@contextlib.contextmanager
def suppress_metrics() -> Iterator[None]:
    """Make every metric observation on this thread a no-op for the
    duration (timers, counters, latency histograms, OTLP span export).

    The self-monitoring scraper writes its registry snapshot through the
    NORMAL ingest path; without this guard those writes would bump the
    very counters the next tick scrapes (stmt/ingest/WAL counters), so
    an idle cluster's metrics would grow forever from the act of
    recording them. propagate() carries the flag into pool workers, so
    the exclusion covers fanned-out parts of a system-table write too."""
    prev = getattr(_tls, "suppress_metrics", False)
    _tls.suppress_metrics = True
    try:
        yield
    finally:
        _tls.suppress_metrics = prev


# ---------------------------------------------------------------------------
# timer metrics (the port's own prometheus registry)
# ---------------------------------------------------------------------------

from .locks import TrackedLock as _TrackedLock
from .tracking import tracked_state as _tracked_state

_metrics_lock = _TrackedLock("common.telemetry_metrics")
_REGISTRY: list = [None]


def registry():
    """The port's prometheus_client CollectorRegistry, made at first use
    (every metric of this module registers here, never in the default
    REGISTRY; None without prometheus_client)."""
    if _REGISTRY[0] is None:
        try:
            from prometheus_client import CollectorRegistry
        except ImportError:  # pragma: no cover
            return None
        with _metrics_lock:
            if _REGISTRY[0] is None:
                _REGISTRY[0] = CollectorRegistry()
    return _REGISTRY[0]

_histograms: Dict[str, object] = _tracked_state(
    {}, "telemetry.histograms")
_counters: Dict[str, object] = _tracked_state({}, "telemetry.counters")
#: sanitized key → the original name that claimed it. Distinct originals
#: sanitizing to one key ("a.b" and "a-b" → "a_b") used to silently share
#: one time series; now the newcomer is deterministically disambiguated
#: (crc suffix) and the collision is logged.
_sanitized_owners: Dict[str, str] = _tracked_state(
    {}, "telemetry.sanitized_owners")


def _sanitize(name: str) -> str:
    # takes _metrics_lock itself (callers call it BEFORE their own
    # acquire): two threads first-time-sanitizing colliding names must
    # agree on one owner, and the collision remap below is check-then-set
    key = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    with _metrics_lock:
        owner = _sanitized_owners.setdefault(key, name)
        collided = owner != name
    if collided:
        import zlib
        crc = zlib.crc32(name.encode()) & 0xFFFF
        key2 = f"{key}_x{crc:04x}"
        with _metrics_lock:
            first_remap = key2 not in _sanitized_owners
            if first_remap:
                _sanitized_owners[key2] = name
        if first_remap:
            logger.error(
                "metric name collision: %r and %r both sanitize to %r; "
                "recording %r as %r instead", owner, name, key, name, key2)
        return key2
    return key


def _observe(name: str, seconds: float) -> None:
    if metrics_suppressed():
        return
    try:
        from prometheus_client import Histogram
    except ImportError:  # pragma: no cover
        return
    key = _sanitize(name)
    reg = registry()        # takes _metrics_lock: before the block
    with _metrics_lock:
        h = _histograms.get(key)
        if h is None:
            h = Histogram(f"greptime_{key}_seconds", f"timer {name}",
                          registry=reg)
            _histograms[key] = h
    h.observe(seconds)


def increment_counter(name: str, value: int = 1) -> None:
    if metrics_suppressed():
        return
    try:
        from prometheus_client import Counter
    except ImportError:  # pragma: no cover
        return
    key = _sanitize(name)
    reg = registry()        # takes _metrics_lock: before the block
    with _metrics_lock:
        c = _counters.get(key)
        if c is None:
            c = Counter(f"greptime_{key}_total", f"counter {name}",
                        registry=reg)
            _counters[key] = c
    c.inc(value)


@contextlib.contextmanager
def timer(name: str) -> Iterator[None]:
    """reference `timer!` macro: records elapsed seconds on exit."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _observe(name, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# latency histograms (log-bucketed; reference: the HISTOGRAM_* statics in
# src/servers/src/metrics.rs — per-protocol request latency distributions
# exported in Prometheus histogram text format)
# ---------------------------------------------------------------------------

#: geometric (×2) bucket bounds, 100µs … ~52s: log-spaced so one layout
#: resolves both a 300µs cache hit and a 30s cold scan with bounded
#: relative error; exported as cumulative `le` buckets on /metrics.
LATENCY_BUCKETS = tuple(1e-4 * (2.0 ** k) for k in range(20))

#: sanitized key → (Histogram, labelnames) for observe_latency metrics
_latency_hists: Dict[str, tuple] = _tracked_state(
    {}, "telemetry.latency_hists")

#: (key, labelnames) pairs already warned about — mismatches log once
_latency_label_mismatches: set = _tracked_state(
    set(), "telemetry.latency_label_mismatches")


def observe_latency(name: str, seconds: float,
                    **labels: object) -> None:
    """Record one observation on the log-bucketed latency histogram
    `greptime_<name>_seconds{**labels}`. Label NAMES must be stable per
    metric (prometheus fixes them at creation); a mismatched call is
    dropped with an error instead of raising on a hot path."""
    if metrics_suppressed():
        return
    try:
        from prometheus_client import Histogram
    except ImportError:  # pragma: no cover
        return
    key = _sanitize(name)
    reg = registry()        # takes _metrics_lock: before the block
    labelnames = tuple(sorted(labels))
    with _metrics_lock:
        entry = _latency_hists.get(key)
        if entry is None:
            try:
                h = Histogram(f"greptime_{key}_seconds", f"latency {name}",
                              labelnames=labelnames,
                              buckets=LATENCY_BUCKETS,
                              registry=reg)
            except ValueError:
                # name already registered (e.g. a timer() minted
                # greptime_<key>_seconds first): drop observations
                # instead of raising on the request hot path, and cache
                # the verdict so only the first call pays the logging
                logger.error(
                    "latency metric %r collides with an existing "
                    "greptime_%s_seconds series; observations dropped",
                    name, key)
                h = None
            entry = _latency_hists[key] = (h, labelnames)
    h, created_names = entry
    if h is None:
        return
    if created_names != labelnames:
        # log once per (metric, label-set) pair, not once per statement:
        # a mismatched hot-path call site would otherwise flood the log
        # at request rate
        warn_key = (key, labelnames)
        with _metrics_lock:
            seen = warn_key in _latency_label_mismatches
            _latency_label_mismatches.add(warn_key)
        if not seen:
            logger.error("latency metric %r called with labels %r but "
                         "created with %r; observations dropped", name,
                         labelnames, created_names)
        return
    (h.labels(**labels) if labelnames else h).observe(float(seconds))


# ---------------------------------------------------------------------------
# registry snapshot (the ONE reader behind /metrics-equivalent views)
# ---------------------------------------------------------------------------

def collect_families() -> list:
    """One walk of the port's Prometheus registry (`registry()`)."""
    reg = registry()
    return list(reg.collect()) if reg is not None else []


def registry_snapshot(families: Optional[list] = None
                      ) -> List[Tuple[str, str, float, str]]:
    """Every sample in the registry as (name, labels_str, value, kind)
    rows. Pass pre-collected `families` to share one registry walk with
    other consumers (runtime_metrics reuses it for the pXX rows)."""
    if families is None:
        families = collect_families()
    rows = []
    for family in families:
        for s in family.samples:
            labels = "{" + ", ".join(
                f'{k}="{v}"' for k, v in sorted(s.labels.items())) + "}" \
                if s.labels else ""
            rows.append((s.name, labels, float(s.value), family.type))
    return rows


def latency_summaries(quantiles: Sequence[float] = (0.5, 0.95, 0.99),
                      families: Optional[list] = None
                      ) -> List[Tuple[str, str, float]]:
    """(name_pNN, labels_str, value_seconds) estimates for every
    histogram in the registry, interpolated from its cumulative buckets —
    the p50/p95/p99 rows information_schema.runtime_metrics serves next
    to the raw counters. Pass `families` (pre-collected metric families)
    to reuse one registry walk for both the raw samples and these
    summaries."""
    if families is None:
        families = collect_families()
    out = []
    for family in families:
        if family.type != "histogram":
            continue
        groups: Dict[tuple, list] = {}
        for s in family.samples:
            if not s.name.endswith("_bucket"):
                continue
            key = tuple(sorted((k, v) for k, v in s.labels.items()
                               if k != "le"))
            groups.setdefault(key, []).append(
                (float(s.labels["le"]), float(s.value)))
        for key, buckets in groups.items():
            buckets.sort()
            total = buckets[-1][1]
            if total <= 0:
                continue
            labels = "{" + ", ".join(f'{k}="{v}"' for k, v in key) + "}" \
                if key else ""
            for q in quantiles:
                target = q * total
                prev_le, prev_c = 0.0, 0.0
                value = buckets[-1][0]
                for le, c in buckets:
                    if c >= target:
                        if le == float("inf"):
                            # open-ended tail: clamp at the last finite
                            # bound instead of inventing a magnitude
                            value = prev_le
                        else:
                            frac = (target - prev_c) / max(c - prev_c,
                                                           1e-12)
                            value = prev_le + (le - prev_le) * frac
                        break
                    prev_le, prev_c = le, c
                out.append((f"{family.name}_seconds_p{int(q * 100)}"
                            if not family.name.endswith("_seconds")
                            else f"{family.name}_p{int(q * 100)}",
                            labels, value))
    return out
