"""SelfMonitor: scrape the node's own telemetry into system tables.

The pipeline (reference: GreptimeDB's export-metrics-to-self design):

1. **Snapshot first, write second.** Each tick snapshots the shared
   Prometheus registry (`telemetry.registry_snapshot`) and the
   per-region heat facts BEFORE performing any write, then writes both
   through the *normal ingest path* (`handle_row_insert`, the same
   auto-create/alter route protocol ingest takes) into
   `greptime_private.node_metrics` and `greptime_private.region_heat`.
2. **Never recurse.** The writes run under
   `telemetry.suppress_metrics()`: counters/timers/spans they would
   bump are no-ops, so the next tick's snapshot does not grow from the
   act of recording the previous one — metric values converge on an
   idle node instead of self-amplifying (regression-tested). The
   region-heat walk also skips `greptime_private` itself.
3. **History is ordinary data.** The system tables are plain mito (or
   distributed) tables: SQL/PromQL query them, flows roll them up,
   compaction applies, and the scraper's own retention sweep
   (`SET self_monitor_retention_ms` / GREPTIME_SELF_MONITOR_RETENTION_MS)
   deletes aged rows through the normal DELETE path.

Region heat is what elastic regions need as *history* to drive
split/migrate: standalone nodes walk their own regions and derive
per-region ingest rates from consecutive ticks; distributed frontends
read the cluster-wide per-(node, region) heat the meta service
accumulates from heartbeats (`MetaSrv.region_heat`).

Ported from greptimedb_tpu/monitor/scraper.py unchanged in behavior. The
snapshot reads the port's own registry (`telemetry.registry_snapshot`
over `telemetry.registry()`, where every port metric registers; the
default prometheus_client REGISTRY holds none of them). The standalone
frontend passes no `meta`, so heat comes from `_local_heat_rows` over
the port's regions; a distributed frontend passes its meta client.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Tuple

logger = logging.getLogger(__name__)

PRIVATE_SCHEMA = "greptime_private"
NODE_METRICS_TABLE = "node_metrics"
REGION_HEAT_TABLE = "region_heat"

#: retention for the self-monitoring tables, milliseconds; 0 disables
#: the sweep. Process-wide (SET self_monitor_retention_ms) like the
#: other observability knobs.
from ..common.runtime import env_int as _env_int

_RETENTION_MS: List[int] = [_env_int("GREPTIME_SELF_MONITOR_RETENTION_MS",
                                     7 * 24 * 3600 * 1000)]


def configure_retention(ms: int) -> None:
    """SET self_monitor_retention_ms — 0 disables the sweep."""
    _RETENTION_MS[0] = max(0, int(ms))


def retention_ms() -> int:
    return _RETENTION_MS[0]


class SelfMonitor:
    """One node's scrape loop: cooperative `tick()` (the test surface)
    plus an opt-in RepeatedTask, the FlowManager pattern."""

    def __init__(self, instance, node_label: str = "standalone",
                 meta=None):
        #: the hosting frontend: handle_row_insert + catalog are the
        #: only surface used, so standalone and distributed wire alike
        self.instance = instance
        self.catalog = instance.catalog
        self.node_label = node_label
        self.meta = meta
        from ..common.locks import TrackedLock
        from ..common.tracking import tracked_state
        self._lock = TrackedLock("monitor.scraper")
        self._task = None
        #: (node, region) -> (rows, monotonic_t) of the previous tick,
        #: for the locally-derived per-region ingest rate
        self._prev_heat: Dict[Tuple[str, str], Tuple[int, float]] = {}
        self.stats: Dict[str, object] = tracked_state({
            "ticks": 0, "metric_rows": 0, "heat_rows": 0,
            "rows_written": 0, "retention_deleted": 0,
            "last_tick_ms": 0.0, "last_error": None,
        }, "monitor.scraper.stats")

    # ---- lifecycle ----
    def start_background(self, interval_s: float = 30.0) -> None:
        if self._task is not None:
            return
        from ..storage.scheduler import RepeatedTask
        self._task = RepeatedTask(interval_s, self.tick,
                                  name="self-monitor")
        self._task.start()

    def stop(self) -> None:
        if self._task is not None:
            self._task.stop()
            self._task = None

    # ---- one scrape ----
    def tick(self) -> int:
        """Scrape + write once; returns rows written. Serialized (the
        background task and a test-driven tick must not interleave) and
        error-contained — a failed scrape logs and shows up in the
        self_monitor view, never breaks the host. Runs as a background
        job (own root trace + background_jobs row), like every other
        scheduler-driven loop."""
        from ..common import background_jobs
        from ..common.telemetry import suppress_metrics
        # suppressed END TO END (not just the writes): the tick's own
        # root span must not bump a histogram either, or idle ticks
        # would never converge — the scraper observes, it is not
        # observed (its background_jobs row still registers)
        with suppress_metrics(), background_jobs.job("self_monitor"):
            return self._tick_inner()

    def _tick_inner(self) -> int:
        from ..common.telemetry import registry_snapshot, suppress_metrics
        with self._lock:
            t0 = time.perf_counter()
            now_ms = int(time.time() * 1000)
            try:
                # snapshot BEFORE writing: this tick's own ingest must
                # not appear in the samples it persists
                samples = registry_snapshot()
                heat = self._heat_rows()
                from ..common import admission
                with suppress_metrics(), admission.exempt():
                    # admission-exempt like the metrics suppression:
                    # shedding the observer during overload would blind
                    # the operator exactly when they need the data
                    written = self._write_metrics(samples, now_ms)
                    written += self._write_heat(heat, now_ms)
                    # traces and profile samples flush BEFORE the sweep
                    # so a tightened trace_retention_ms /
                    # profile_retention_ms applies to just-written rows
                    # on the same tick
                    written += self._flush_traces()
                    written += self._flush_profile()
                    deleted = self._enforce_retention(now_ms)
                self.stats["ticks"] = int(self.stats["ticks"]) + 1
                self.stats["metric_rows"] = \
                    int(self.stats["metric_rows"]) + len(samples)
                self.stats["heat_rows"] = \
                    int(self.stats["heat_rows"]) + len(heat)
                self.stats["rows_written"] = \
                    int(self.stats["rows_written"]) + written
                self.stats["retention_deleted"] = \
                    int(self.stats["retention_deleted"]) + deleted
                self.stats["last_error"] = None
                return written
            except Exception as e:  # noqa: BLE001 — background-loop
                logger.exception("self-monitor tick failed")  # safety
                self.stats["last_error"] = str(e)
                return 0
            finally:
                self.stats["last_tick_ms"] = \
                    (time.perf_counter() - t0) * 1e3

    # ---- writers ----
    def _ctx(self):
        from ..session import QueryContext
        return QueryContext(current_schema=PRIVATE_SCHEMA)

    def _write_metrics(self, samples, now_ms: int) -> int:
        if not samples:
            return 0
        from ..datatypes.data_type import FLOAT64, STRING
        n = len(samples)
        cols = {
            "node": [self.node_label] * n,
            "metric_name": [s[0] for s in samples],
            "labels": [s[1] for s in samples],
            "ts": [now_ms] * n,
            "value": [float(s[2]) for s in samples],
            "kind": [s[3] for s in samples],
        }
        return self.instance.handle_row_insert(
            NODE_METRICS_TABLE, cols,
            tag_columns=("node", "metric_name", "labels"),
            timestamp_column="ts",
            types={"value": FLOAT64, "kind": STRING,
                   "node": STRING, "metric_name": STRING,
                   "labels": STRING},
            ctx=self._ctx())

    def _write_heat(self, heat: List[dict], now_ms: int) -> int:
        if not heat:
            return 0
        from ..datatypes.data_type import FLOAT64, INT64, STRING
        cols = {
            "node": [h["node"] for h in heat],
            "region": [h["region"] for h in heat],
            "ts": [now_ms] * len(heat),
            "rows": [int(h["rows"]) for h in heat],
            "size_bytes": [int(h["size_bytes"]) for h in heat],
            "ingest_rate_rps": [float(h["ingest_rate_rps"])
                                for h in heat],
        }
        return self.instance.handle_row_insert(
            REGION_HEAT_TABLE, cols, tag_columns=("node", "region"),
            timestamp_column="ts",
            types={"node": STRING, "region": STRING, "rows": INT64,
                   "size_bytes": INT64, "ingest_rate_rps": FLOAT64},
            ctx=self._ctx())

    # ---- heat sources ----
    def _heat_rows(self) -> List[dict]:
        """Per-(node, region) heat facts for this tick. Cluster-wide via
        the meta service when this frontend has one (heartbeat-fed, so
        every datanode reports even though only the frontend scrapes);
        local region walk otherwise."""
        meta = self.meta
        if meta is not None and hasattr(meta, "region_heat"):
            try:
                return list(meta.region_heat())
            except Exception:  # noqa: BLE001 — heat over a flaky meta
                logger.exception(       # degrades; metrics still write
                    "self-monitor: meta region_heat unavailable")
                return []
        return self._local_heat_rows()

    def _local_heat_rows(self) -> List[dict]:
        from .. import DEFAULT_CATALOG_NAME
        from ..query.stream_exec import region_stat_entries
        regions = []
        catalog = DEFAULT_CATALOG_NAME
        for schema_name in self.catalog.schema_names(catalog):
            if schema_name in (PRIVATE_SCHEMA, "information_schema"):
                continue             # never scrape the scrape target
            for tname in self.catalog.table_names(catalog, schema_name):
                t = self.catalog.table(catalog, schema_name, tname)
                regions.extend(
                    (getattr(t, "regions", None) or {}).values())
        entries, _, _ = region_stat_entries(regions)
        now = time.monotonic()
        out = []
        fresh: Dict[Tuple[str, str], Tuple[int, float]] = {}
        for e in entries:
            key = (self.node_label, e["region"])
            prev = self._prev_heat.get(key)
            rate = 0.0
            if prev is not None and now > prev[1]:
                rate = max(0.0, (e["rows"] - prev[0]) / (now - prev[1]))
            fresh[key] = (e["rows"], now)
            out.append({"node": self.node_label, "region": e["region"],
                        "rows": e["rows"], "size_bytes": e["size_bytes"],
                        "ingest_rate_rps": round(rate, 3)})
        self._prev_heat = fresh
        return out

    #: per-tick sweep ceiling: the first sweep after days of retention
    #: being off (or after tightening the window) must not materialize
    #: millions of key rows inside the scrape lock — it deletes up to
    #: this many rows per table per tick and catches up tick by tick
    SWEEP_BATCH_ROWS = 50_000

    # ---- trace-store flush (common/trace_store.py) ----
    def _flush_traces(self) -> int:
        """Write retained spans queued by the process-wide trace sink,
        and TTL-evict verdictless buffered traces. The sink's flush runs
        under its own suppress_metrics guard."""
        from ..common import trace_store
        sink = trace_store.sink()
        if sink is None:
            return 0
        sink.evict_expired()
        return sink.flush()

    def _flush_profile(self) -> int:
        """Persist the continuous profiler's aggregated folded stacks
        (common/profiler.py). Writer-less samplers (datanode processes)
        report flush() == 0 and keep buffering until drained over
        Flight; the sampler's flush has its own suppress guard."""
        from ..common import profiler
        s = profiler.sampler()
        if s is None:
            return 0
        return s.flush()

    # ---- retention ----
    def _enforce_retention(self, now_ms: int) -> int:
        """Delete system-table rows older than the retention window —
        the same key-scan + delete path user DELETEs take, so the sweep
        works on both topologies. trace_spans sweeps on its own, shorter
        leash (SET trace_retention_ms, default 3d): traces are bulkier
        than metrics."""
        from ..common import trace_store
        deleted = 0
        keep_ms = retention_ms()
        if keep_ms > 0:
            for tname in (NODE_METRICS_TABLE, REGION_HEAT_TABLE):
                deleted += self._sweep_table(tname, now_ms - keep_ms)
        trace_keep_ms = trace_store.retention_ms()
        if trace_keep_ms > 0:
            deleted += self._sweep_table(trace_store.TRACE_SPANS_TABLE,
                                         now_ms - trace_keep_ms)
        from ..common import profiler
        prof_keep_ms = profiler.retention_ms()
        if prof_keep_ms > 0:
            deleted += self._sweep_table(
                profiler.PROFILE_SAMPLES_TABLE, now_ms - prof_keep_ms)
        if deleted:
            logger.info("self-monitor: retention swept %d row(s)",
                        deleted)
        return deleted

    def _sweep_table(self, tname: str, cutoff: int) -> int:
        """Batched key-scan + delete of one system table's expired rows
        (at most SWEEP_BATCH_ROWS per tick — backlogs drain tick by
        tick instead of materializing inside the scrape lock)."""
        from .. import DEFAULT_CATALOG_NAME
        from ..common.time import TimestampRange
        table = self.catalog.table(DEFAULT_CATALOG_NAME,
                                   PRIVATE_SCHEMA, tname)
        if table is None:
            return 0
        schema = table.schema
        tc = schema.timestamp_column
        key_cols = schema.tag_names() + [tc.name]
        old: Dict[str, list] = {c: [] for c in key_cols}
        budget = self.SWEEP_BATCH_ROWS
        for b in table.scan_batches(
                projection=key_cols,
                time_range=TimestampRange(None, cutoff)):
            d = b.to_pydict()
            take = min(budget, len(d[tc.name]))
            for c in key_cols:
                old[c].extend(d[c][:take])
            budget -= take
            if budget <= 0:
                break
        n = len(old[tc.name])
        if n:
            table.delete(old)
        return n

    # ---- introspection (information_schema.self_monitor) ----
    def row(self) -> Dict[str, object]:
        return {
            "node": self.node_label,
            "ticks": int(self.stats["ticks"]),
            "metric_rows": int(self.stats["metric_rows"]),
            "heat_rows": int(self.stats["heat_rows"]),
            "rows_written": int(self.stats["rows_written"]),
            "retention_deleted": int(self.stats["retention_deleted"]),
            "retention_ms": retention_ms(),
            "last_tick_ms": float(self.stats["last_tick_ms"]),
            "last_error": self.stats["last_error"],
        }
