"""information_schema virtual tables.

Reference behavior: the reference serves `information_schema` through
the catalog's schema provider (exercised by
tests/cases/standalone/common/system/information_schema.sql). Virtual
tables are materialized from live catalog state at scan time:

- information_schema.tables  — one row per registered table
- information_schema.columns — one row per column of every table
- information_schema.runtime_metrics — every sample the prometheus
  registry would export on /metrics (same counters, same values), plus
  live engine gauges (region/memtable/SST state, scan-cache residency,
  object-store read-cache hit ratio) — so metrics are queryable over
  SQL exactly like the /metrics endpoint.

Ported from greptimedb_tpu/catalog/information_schema.py. The port serves
tables, columns, flows, failpoints, cluster_info, region_peers, processes,
background_jobs and runtime_metrics (from the port's own Prometheus
registry, common/telemetry.registry(), with the flow gauges of the
catalog's FlowManager). cluster_info and region_peers read the meta
service on a clustered frontend (DistInstance pins `meta_client` on its
catalog; an unreachable meta yields no rows, as in the reference) and are
synthesized from the local regions standalone. self_monitor reads the
frontend's SelfMonitor (monitor/); trace_spans and profile_samples are
views over greptime_private.trace_spans and
greptime_private.profile_samples, flushed from the trace sink and the
profiler first (common/trace_store.py, common/profiler.py) after the
datanodes of a clustered frontend (`dist_clients`) were pinged or
drained; background_jobs merges those datanodes' and meta's registries.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

from ..datatypes import data_type as dt
from ..datatypes.record_batch import RecordBatch
from ..datatypes.schema import ColumnSchema, Schema
from ..table.metadata import TableIdent, TableInfo, TableMeta, TableType
from ..table.table import Table

logger = logging.getLogger(__name__)

INFORMATION_SCHEMA_NAME = "information_schema"

_TABLES_SCHEMA = Schema([
    ColumnSchema("table_catalog", dt.STRING),
    ColumnSchema("table_schema", dt.STRING),
    ColumnSchema("table_name", dt.STRING),
    ColumnSchema("table_type", dt.STRING),
    ColumnSchema("table_id", dt.INT64),
    ColumnSchema("engine", dt.STRING),
])

_COLUMNS_SCHEMA = Schema([
    ColumnSchema("table_catalog", dt.STRING),
    ColumnSchema("table_schema", dt.STRING),
    ColumnSchema("table_name", dt.STRING),
    ColumnSchema("column_name", dt.STRING),
    ColumnSchema("data_type", dt.STRING),
    ColumnSchema("semantic_type", dt.STRING),
    ColumnSchema("is_nullable", dt.STRING),
])

_RUNTIME_METRICS_SCHEMA = Schema([
    ColumnSchema("metric_name", dt.STRING),
    ColumnSchema("labels", dt.STRING),
    ColumnSchema("value", dt.FLOAT64),
    ColumnSchema("kind", dt.STRING),
])

_FAILPOINTS_SCHEMA = Schema([
    ColumnSchema("name", dt.STRING),
    ColumnSchema("action", dt.STRING, nullable=True),
    ColumnSchema("hits", dt.INT64),
    ColumnSchema("fires", dt.INT64),
])

_CLUSTER_INFO_SCHEMA = Schema([
    ColumnSchema("peer_id", dt.INT64),
    ColumnSchema("peer_type", dt.STRING),
    ColumnSchema("peer_addr", dt.STRING),
    ColumnSchema("lease_state", dt.STRING),
    ColumnSchema("last_seen_ms", dt.INT64, nullable=True),
    ColumnSchema("region_count", dt.INT64),
    ColumnSchema("approximate_rows", dt.INT64),
    ColumnSchema("ingest_rate_rps", dt.FLOAT64),
    ColumnSchema("region_stats", dt.STRING),
])

_REGION_PEERS_SCHEMA = Schema([
    ColumnSchema("table_name", dt.STRING),
    ColumnSchema("region_number", dt.INT64),
    ColumnSchema("peer_id", dt.INT64),
    ColumnSchema("peer_addr", dt.STRING),
    ColumnSchema("is_leader", dt.STRING),
    ColumnSchema("status", dt.STRING),
    # read replicas: the leader row's replicated_seq is its
    # committed sequence; a follower row's is its applied position, and
    # lag_ms bounds its staleness (0 = caught up, NULL = no beat yet)
    ColumnSchema("replicated_seq", dt.INT64, nullable=True),
    ColumnSchema("lag_ms", dt.INT64, nullable=True),
    ColumnSchema("route_version", dt.INT64),
    ColumnSchema("operation", dt.STRING, nullable=True),
    ColumnSchema("op_id", dt.STRING, nullable=True),
])

_PROCESSES_SCHEMA = Schema([
    ColumnSchema("id", dt.INT64),
    ColumnSchema("node", dt.STRING),
    ColumnSchema("catalog", dt.STRING),
    ColumnSchema("schema", dt.STRING),
    ColumnSchema("query", dt.STRING),
    ColumnSchema("protocol", dt.STRING),
    ColumnSchema("state", dt.STRING),
    ColumnSchema("trace_id", dt.STRING),
    ColumnSchema("elapsed_ms", dt.FLOAT64),
    ColumnSchema("rows_scanned", dt.INT64),
    ColumnSchema("bytes_read", dt.INT64),
    ColumnSchema("rpcs", dt.INT64),
    ColumnSchema("partial_bytes", dt.INT64),
])




_BACKGROUND_JOBS_SCHEMA = Schema([
    ColumnSchema("job_id", dt.INT64),
    ColumnSchema("kind", dt.STRING),
    ColumnSchema("table_name", dt.STRING, nullable=True),
    ColumnSchema("region", dt.STRING, nullable=True),
    ColumnSchema("node", dt.STRING),
    ColumnSchema("state", dt.STRING),
    ColumnSchema("trace_id", dt.STRING),
    ColumnSchema("start_ms", dt.INT64),
    ColumnSchema("duration_ms", dt.FLOAT64, nullable=True),
    ColumnSchema("error", dt.STRING, nullable=True),
    ColumnSchema("detail", dt.STRING, nullable=True),
])

_FLOWS_SCHEMA = Schema([
    ColumnSchema("flow_name", dt.STRING),
    ColumnSchema("source_table", dt.STRING),
    ColumnSchema("sink_table", dt.STRING),
    ColumnSchema("stride_ms", dt.INT64),
    ColumnSchema("aggs", dt.STRING),
    ColumnSchema("watermark", dt.INT64, nullable=True),
    ColumnSchema("folds", dt.INT64),
    ColumnSchema("rows_folded", dt.INT64),
    ColumnSchema("buckets_written", dt.INT64),
])


def _engine_gauges(catalog_manager, catalog_name: str):
    """Live engine state as gauge samples: per-region storage facts plus
    process-wide cache gauges. These exist even before any metric has
    been observed, so `SELECT ... WHERE metric_name = 'greptime_...'`
    over a fresh server is deterministic (the sqlness golden relies on
    that)."""
    rows = []          # (name, labels, value, kind)
    region_count = 0
    for schema_name in catalog_manager.schema_names(catalog_name):
        for tname in catalog_manager.table_names(catalog_name,
                                                 schema_name):
            t = catalog_manager.table(catalog_name, schema_name, tname)
            regions = getattr(t, "regions", None)
            if not regions:
                continue
            for rnum, region in sorted(regions.items()):
                region_count += 1
                vc = getattr(region, "version_control", None)
                if vc is None:
                    continue
                v = vc.current
                labels = (f'{{region="{rnum}", schema="{schema_name}", '
                          f'table="{tname}"}}')
                mt_rows = sum(m.num_rows
                              for m in v.memtables.all_memtables())
                files = list(v.ssts.all_files())
                rows.append(("greptime_region_memtable_rows", labels,
                             float(mt_rows), "gauge"))
                rows.append(("greptime_region_sst_files", labels,
                             float(len(files)), "gauge"))
                rows.append(("greptime_region_sst_rows", labels,
                             float(sum(f.num_rows for f in files)),
                             "gauge"))
    rows.append(("greptime_region_count", "", float(region_count),
                 "gauge"))
    # flow fold state: watermark timestamp + lifetime counters per flow
    # (the flow_* prometheus counters cover rates; these are the gauges)
    fm = getattr(catalog_manager, "flow_manager", None)
    if fm is not None:
        for spec in fm.flows(catalog_name):
            labels = f'{{flow="{spec.name}", source="{spec.source}"}}'
            wm = spec.watermark_ts()
            if wm is not None:
                rows.append(("greptime_flow_watermark_ts", labels,
                             float(wm), "gauge"))
            rows.append(("greptime_flow_rows_folded", labels,
                         float(spec.stats.get("rows_folded", 0)),
                         "gauge"))
            rows.append(("greptime_flow_buckets_written", labels,
                         float(spec.stats.get("buckets_written", 0)),
                         "gauge"))
    from ..query.tpu_exec import SCAN_CACHE
    rows.append(("greptime_scan_cache_resident_bytes", "",
                 float(SCAN_CACHE.resident_bytes()), "gauge"))
    store = getattr(catalog_manager, "store", None)
    hit_ratio = getattr(store, "hit_ratio", None)
    if callable(hit_ratio):
        rows.append(("greptime_read_cache_hit_ratio", "",
                     float(hit_ratio()), "gauge"))
    return rows


def _collect_families():
    """One walk of the port's Prometheus registry, shared by the raw
    sample rows and the pXX summaries (the registry grows with statement
    kinds × protocols × routes — don't materialize it twice per query).
    Delegates to the telemetry helper so this view, /metrics and the
    self-monitoring scraper read the SAME walk and label formatting —
    greptime_private.node_metrics can never diverge from
    runtime_metrics."""
    from ..common.telemetry import collect_families
    return collect_families()


def _prometheus_samples(families=None):
    """Every sample of the port's Prometheus registry, as /metrics would
    render it."""
    from ..common.telemetry import registry_snapshot
    return registry_snapshot(families)


def _latency_summary_rows(families=None):
    """p50/p95/p99 gauge rows interpolated from every histogram in the
    registry (telemetry.latency_summaries) — the summarized view of the
    log-bucketed latency distributions next to their raw samples."""
    from ..common.telemetry import latency_summaries
    return [(name, labels, float(value), "summary")
            for name, labels, value in latency_summaries(
                families=families)]


def _cluster_nodes(catalog_manager, catalog_name: str):
    """cluster_info rows: from the meta service when this frontend is
    clustered (DistInstance pins `meta_client` on its catalog), else a
    single synthesized row for the standalone process so the view exists
    on every topology."""
    meta = getattr(catalog_manager, "meta_client", None)
    if meta is not None and hasattr(meta, "cluster_info"):
        try:
            # advisory() bounds a failover client to one quick pass over
            # the replicas: the health view must degrade immediately
            # when meta is down, not stall behind the write-path's
            # multi-round retry budget
            if hasattr(meta, "advisory"):
                meta = meta.advisory()
            return meta.cluster_info()
        except Exception:  # noqa: BLE001 — health view over a flaky
            logger.exception(           # meta must degrade, not 500
                "cluster_info: meta unreachable")
            return []
    import json as _json
    import time as _time
    from ..query.stream_exec import region_stat_entries
    regions = []
    for schema_name in catalog_manager.schema_names(catalog_name):
        for tname in catalog_manager.table_names(catalog_name,
                                                 schema_name):
            t = catalog_manager.table(catalog_name, schema_name, tname)
            regions.extend((getattr(t, "regions", None) or {}).values())
    region_stats, total_rows, _ = region_stat_entries(regions)
    return [{
        "peer_id": 0, "peer_type": "standalone", "peer_addr": "",
        "lease_state": "alive", "last_seen_ms": int(_time.time() * 1000),
        "region_count": len(region_stats),
        "approximate_rows": total_rows, "ingest_rate_rps": 0.0,
        "region_stats": _json.dumps(region_stats,
                                    separators=(",", ":")),
    }]


def _dist_clients(catalog_manager) -> list:
    """The datanode clients a clustered frontend pinned on its catalog
    (none standalone)."""
    clients = getattr(catalog_manager, "dist_clients", None)
    return list(dict(clients).values()) if clients else []


def _region_peer_rows(catalog_manager, catalog_name: str):
    """region_peers rows: placement + lease state + in-flight balancer
    operation per (table, region). Meta-backed on a clustered frontend
    (same advisory degradation as cluster_info); synthesized from local
    regions standalone so the view exists on every topology."""
    meta = getattr(catalog_manager, "meta_client", None)
    if meta is not None and hasattr(meta, "region_peers"):
        try:
            if hasattr(meta, "advisory"):
                meta = meta.advisory()
            return meta.region_peers()
        except Exception:  # noqa: BLE001 — health view over a flaky
            logger.exception(           # meta must degrade, not 500
                "region_peers: meta unreachable")
            return []
    rows = []
    for schema_name in catalog_manager.schema_names(catalog_name):
        for tname in catalog_manager.table_names(catalog_name,
                                                 schema_name):
            t = catalog_manager.table(catalog_name, schema_name, tname)
            regions = getattr(t, "regions", None)
            if not regions:
                continue
            for rn in sorted(regions):
                vc = getattr(regions[rn], "version_control", None)
                rows.append({
                    "table_name":
                        f"{catalog_name}.{schema_name}.{tname}",
                    "region_number": rn, "peer_id": 0, "peer_addr": "",
                    "is_leader": "Yes", "status": "ALIVE",
                    "replicated_seq": int(vc.committed_sequence)
                    if vc is not None else None,
                    "lag_ms": 0,
                    "route_version": 0, "operation": None,
                    "op_id": None,
                })
    return rows


_SELF_MONITOR_SCHEMA = Schema([
    ColumnSchema("node", dt.STRING),
    ColumnSchema("ticks", dt.INT64),
    ColumnSchema("metric_rows", dt.INT64),
    ColumnSchema("heat_rows", dt.INT64),
    ColumnSchema("rows_written", dt.INT64),
    ColumnSchema("retention_deleted", dt.INT64),
    ColumnSchema("retention_ms", dt.INT64),
    ColumnSchema("last_tick_ms", dt.FLOAT64),
    ColumnSchema("last_error", dt.STRING, nullable=True),
])

_TRACE_SPANS_SCHEMA = Schema([
    ColumnSchema("trace_id", dt.STRING),
    ColumnSchema("span_id", dt.STRING),
    ColumnSchema("parent_span_id", dt.STRING, nullable=True),
    ColumnSchema("node", dt.STRING),
    ColumnSchema("service", dt.STRING),
    ColumnSchema("span_name", dt.STRING),
    ColumnSchema("ts", dt.INT64),
    ColumnSchema("duration_ms", dt.FLOAT64),
    ColumnSchema("status", dt.STRING),
    ColumnSchema("attrs", dt.STRING, nullable=True),
])

_PROFILE_SAMPLES_SCHEMA = Schema([
    ColumnSchema("node", dt.STRING),
    ColumnSchema("kind", dt.STRING),
    ColumnSchema("id", dt.STRING),
    ColumnSchema("trace_id", dt.STRING),
    ColumnSchema("stack_id", dt.STRING),
    ColumnSchema("ts", dt.INT64),
    ColumnSchema("stack", dt.STRING),
    ColumnSchema("count", dt.INT64),
])


class _VirtualTable(Table):
    """Read-only table whose rows come from a builder at scan time."""

    def __init__(self, name: str, schema: Schema, builder):
        info = TableInfo(
            ident=TableIdent(3),
            name=name,
            meta=TableMeta(schema=schema, engine="system"),
            schema_name=INFORMATION_SCHEMA_NAME,
            table_type=TableType.TEMPORARY)
        super().__init__(info)
        self._builder = builder

    def scan_batches(self, projection: Optional[Sequence[str]] = None,
                     time_range=None, limit: Optional[int] = None
                     ) -> List[RecordBatch]:
        data = self._builder()
        if limit is not None:
            data = {k: v[:limit] for k, v in data.items()}
        batch = RecordBatch.from_pydict(self.schema, data)
        if projection is not None:
            batch = batch.project(list(projection))
        return [batch]


def _stored_rows(catalog_manager, catalog_name: str, schema: Schema,
                 table_name: str) -> dict:
    """Every row of a greptime_private table in `schema`'s columns (a
    column the table lacks reads as nulls)."""
    rows = {k: [] for k in schema.names()}
    table = catalog_manager.table(catalog_name, "greptime_private",
                                  table_name)
    if table is None:
        return rows
    for b in table.scan_batches():
        d = b.to_pydict()
        for k in rows:
            col = d.get(k)
            rows[k].extend(col if col is not None else [None] * b.num_rows)
    return rows


def information_schema_table(catalog_manager, catalog_name: str,
                             table_name: str) -> Optional[Table]:
    """Resolve `information_schema.<table>` against live catalog state."""
    name = table_name.lower()
    if name == "tables":
        def build_tables():
            rows = {k: [] for k in _TABLES_SCHEMA.names()}
            for schema_name in catalog_manager.schema_names(catalog_name):
                for tname in catalog_manager.table_names(catalog_name,
                                                         schema_name):
                    t = catalog_manager.table(catalog_name, schema_name,
                                              tname)
                    if t is None:
                        continue
                    rows["table_catalog"].append(catalog_name)
                    rows["table_schema"].append(schema_name)
                    rows["table_name"].append(tname)
                    rows["table_type"].append(
                        getattr(t.info.table_type, "value", "BASE TABLE"))
                    rows["table_id"].append(t.info.ident.table_id)
                    rows["engine"].append(t.info.meta.engine)
            return rows
        return _VirtualTable("tables", _TABLES_SCHEMA, build_tables)
    if name == "columns":
        def build_columns():
            rows = {k: [] for k in _COLUMNS_SCHEMA.names()}
            for schema_name in catalog_manager.schema_names(catalog_name):
                for tname in catalog_manager.table_names(catalog_name,
                                                         schema_name):
                    t = catalog_manager.table(catalog_name, schema_name,
                                              tname)
                    if t is None:
                        continue
                    for cs in t.schema.column_schemas:
                        rows["table_catalog"].append(catalog_name)
                        rows["table_schema"].append(schema_name)
                        rows["table_name"].append(tname)
                        rows["column_name"].append(cs.name)
                        rows["data_type"].append(cs.dtype.name)
                        rows["semantic_type"].append(
                            cs.semantic_type.value
                            if hasattr(cs.semantic_type, "value")
                            else str(cs.semantic_type))
                        rows["is_nullable"].append(
                            "YES" if cs.nullable else "NO")
            return rows
        return _VirtualTable("columns", _COLUMNS_SCHEMA, build_columns)
    if name == "flows":
        def build_flows():
            rows = {k: [] for k in _FLOWS_SCHEMA.names()}
            fm = getattr(catalog_manager, "flow_manager", None)
            for spec in (fm.flows(catalog_name) if fm is not None else []):
                rows["flow_name"].append(spec.name)
                rows["source_table"].append(spec.source)
                rows["sink_table"].append(spec.sink)
                rows["stride_ms"].append(spec.stride_ms)
                rows["aggs"].append(", ".join(a.describe()
                                              for a in spec.aggs))
                rows["watermark"].append(spec.watermark_ts())
                rows["folds"].append(spec.stats.get("folds", 0))
                rows["rows_folded"].append(
                    spec.stats.get("rows_folded", 0))
                rows["buckets_written"].append(
                    spec.stats.get("buckets_written", 0))
            return rows
        return _VirtualTable("flows", _FLOWS_SCHEMA, build_flows)
    if name == "failpoints":
        def build_failpoints():
            from ..common import failpoint
            points = failpoint.list_points()
            return {
                "name": [p["name"] for p in points],
                "action": [p["action"] for p in points],
                "hits": [p["hits"] for p in points],
                "fires": [p["fires"] for p in points],
            }
        return _VirtualTable("failpoints", _FAILPOINTS_SCHEMA,
                             build_failpoints)
    if name == "cluster_info":
        def build_cluster_info():
            rows = {k: [] for k in _CLUSTER_INFO_SCHEMA.names()}
            for node in _cluster_nodes(catalog_manager, catalog_name):
                for k in rows:
                    rows[k].append(node.get(k))
            return rows
        return _VirtualTable("cluster_info", _CLUSTER_INFO_SCHEMA,
                             build_cluster_info)
    if name == "region_peers":
        def build_region_peers():
            rows = {k: [] for k in _REGION_PEERS_SCHEMA.names()}
            for peer in _region_peer_rows(catalog_manager, catalog_name):
                for k in rows:
                    rows[k].append(peer.get(k))
            return rows
        return _VirtualTable("region_peers", _REGION_PEERS_SCHEMA,
                             build_region_peers)
    if name == "processes":
        def build_processes():
            from ..common import process_list
            rows = {k: [] for k in _PROCESSES_SCHEMA.names()}
            for r in process_list.REGISTRY.rows():
                for k in rows:
                    rows[k].append(r.get(k))
            return rows
        return _VirtualTable("processes", _PROCESSES_SCHEMA,
                             build_processes)
    if name == "self_monitor":
        def build_self_monitor():
            rows = {k: [] for k in _SELF_MONITOR_SCHEMA.names()}
            mon = getattr(catalog_manager, "self_monitor", None)
            if mon is not None:
                for k, v in mon.row().items():
                    rows[k].append(v)
            return rows
        return _VirtualTable("self_monitor", _SELF_MONITOR_SCHEMA,
                             build_self_monitor)
    if name == "trace_spans":
        def build_trace_spans():
            # a SQL view over the durable store: ping the datanodes
            # (the ordinary RPC piggyback releases freshly-verdicted
            # buffered spans — same sequence as ADMIN SHOW TRACE) and
            # flush the sink first, so "the query just finished" reads
            # see their spans cluster-wide
            from ..common import trace_store
            for client in _dist_clients(catalog_manager):
                ping = getattr(client, "ping", None)
                if ping is None:
                    continue
                try:
                    ping()
                except Exception as e:  # noqa: BLE001 — degrade to
                    logger.debug(       # what the store already holds
                        "trace_spans: span-sync ping failed: %s", e)
            sink = trace_store.sink()
            if sink is not None:
                sink.flush()
            return _stored_rows(catalog_manager, catalog_name,
                                _TRACE_SPANS_SCHEMA,
                                trace_store.TRACE_SPANS_TABLE)
        return _VirtualTable("trace_spans", _TRACE_SPANS_SCHEMA,
                             build_trace_spans)
    if name == "profile_samples":
        def build_profile_samples():
            # a SQL view over the profiler's durable table: drain every
            # reachable datanode's pending aggregate (the same Flight
            # `profile` action ADMIN SHOW PROFILE uses) and flush the
            # local sampler first, so a just-finished query's stacks are
            # visible cluster-wide
            from ..common import profiler
            s = profiler.sampler()
            if s is not None:
                for client in _dist_clients(catalog_manager):
                    fetch = getattr(client, "profile", None)
                    if fetch is None:
                        continue
                    try:
                        s.absorb_rows(fetch(drain=True))
                    except Exception:  # noqa: BLE001 — a dead peer
                        logger.debug(   # degrades, never 500s the view
                            "profile_samples: peer drain failed",
                            exc_info=True)
                s.flush()
            return _stored_rows(catalog_manager, catalog_name,
                                _PROFILE_SAMPLES_SCHEMA,
                                profiler.PROFILE_SAMPLES_TABLE)
        return _VirtualTable("profile_samples", _PROFILE_SAMPLES_SCHEMA,
                             build_profile_samples)
    if name == "background_jobs":
        def build_background_jobs():
            from ..common import background_jobs
            # local registry first, then every reachable datanode's (a
            # dist frontend pins `dist_clients`); dedup by
            # (node, job_id) — an in-process cluster shares one
            # process-wide registry, so the fan-out re-reads it
            merged = {}
            for r in background_jobs.rows():
                merged[(r.get("node"), r.get("job_id"))] = r
            peers = _dist_clients(catalog_manager)
            # the metasrv runs the balancer: its op-step jobs live in
            # ITS registry (advisory() bounds a failover client to one
            # quick pass, the cluster_info precedent)
            meta = getattr(catalog_manager, "meta_client", None)
            if meta is not None and hasattr(meta, "background_jobs"):
                peers.append(meta.advisory() if hasattr(meta, "advisory")
                             else meta)
            for client in peers:
                fetch = getattr(client, "background_jobs", None)
                if fetch is None:
                    continue
                try:
                    for r in fetch():
                        merged.setdefault(
                            (r.get("node"), r.get("job_id")), r)
                except Exception:  # noqa: BLE001 — a dead peer
                    logger.debug(       # degrades, never 500s the view
                        "background_jobs: peer unreachable",
                        exc_info=True)
            ordered = sorted(
                merged.values(),
                key=lambda r: (r.get("state") != "running",
                               str(r.get("node")),
                               -(r.get("job_id") or 0)))
            rows = {k: [] for k in _BACKGROUND_JOBS_SCHEMA.names()}
            for r in ordered:
                for k in rows:
                    rows[k].append(r.get(k))
            return rows
        return _VirtualTable("background_jobs", _BACKGROUND_JOBS_SCHEMA,
                             build_background_jobs)
    if name == "runtime_metrics":
        def build_metrics():
            families = _collect_families()
            samples = _prometheus_samples(families) + \
                _engine_gauges(catalog_manager, catalog_name) + \
                _latency_summary_rows(families)
            samples.sort(key=lambda r: (r[0], r[1]))
            return {
                "metric_name": [r[0] for r in samples],
                "labels": [r[1] for r in samples],
                "value": [r[2] for r in samples],
                "kind": [r[3] for r in samples],
            }
        return _VirtualTable("runtime_metrics", _RUNTIME_METRICS_SCHEMA,
                             build_metrics)
    return None
