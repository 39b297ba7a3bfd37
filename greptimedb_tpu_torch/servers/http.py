"""HTTP API server (aiohttp).

Reference behavior: src/servers/src/http.rs:434-578 — routes /v1/sql,
/v1/promql, /v1/influxdb/write, /v1/opentsdb/api/put,
/v1/prometheus/{write,read}, /metrics, health/status, admin flush, plus the
Prometheus-compatible query API (src/servers/src/prom.rs) mounted under
/api/v1. Responses use the GreptimeDB JSON envelope
{"code": 0, "output": [...], "execution_time_ms": n}.

Ported from greptimedb_tpu/servers/http.py over the port's standalone
frontend: the queries behind the requests run on the frontend's device
("cuda" unless the frontend was built for the CPU), on the executor
threads (`run_in_executor`); the server itself has no device. Where it
differs from the reference:

- `/metrics` serves the port's own registry,
  `generate_latest(common.telemetry.registry())`: the port registers
  nothing in prometheus_client's default REGISTRY, which the reference
  serves.
- `/v1/admin/downsample` reduces on the frontend's device, and the
  coprocessors of `/v1/scripts` and `/v1/run-script` run on it
  (script/).
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from aiohttp import web

from ..errors import AuthError, GreptimeError, StatusCode
from ..query.output import Output
from ..session import Channel, QueryContext
from .. import DEFAULT_CATALOG_NAME, DEFAULT_SCHEMA_NAME
from . import influxdb as influx_mod
from . import opentsdb as tsdb_mod
from . import prometheus as prom_mod
from .auth import NoopUserProvider, UserProvider

logger = logging.getLogger(__name__)


def parse_db_param(db: Optional[str]) -> tuple:
    if not db:
        return DEFAULT_CATALOG_NAME, DEFAULT_SCHEMA_NAME
    if "-" in db:
        catalog, _, schema = db.partition("-")
        return catalog, schema
    return DEFAULT_CATALOG_NAME, db


def output_to_json(out: Output) -> Dict[str, Any]:
    if not out.is_batches:
        return {"affectedrows": out.affected_rows or 0}
    schema = out.schema
    col_schemas = [{"name": c.name, "data_type": c.dtype.name}
                   for c in schema.column_schemas] if schema else []
    rows: List[list] = []
    for b in out.batches or []:
        for r in b.rows():
            rows.append([None if v != v else v
                         if isinstance(v, float) else v for v in r])
    return {"records": {"schema": {"column_schemas": col_schemas},
                        "rows": rows}}


class HttpServer:
    def __init__(self, frontend, user_provider: Optional[UserProvider] = None,
                 addr: str = "127.0.0.1:4000", ssl_context=None):
        self.frontend = frontend
        self.user_provider = user_provider or NoopUserProvider()
        self.ssl_context = ssl_context
        host, _, port = addr.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self._runner: Optional[web.AppRunner] = None
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._started = threading.Event()
        self._start_time = time.time()

    # ---- app ----
    def make_app(self) -> web.Application:
        app = web.Application(middlewares=[self._error_middleware])
        r = app.router
        r.add_route("*", "/v1/sql", self.handle_sql)
        r.add_route("*", "/v1/promql", self.handle_promql)
        r.add_post("/v1/influxdb/write", self.handle_influx_write)
        r.add_post("/v1/influxdb/api/v2/write", self.handle_influx_write)
        r.add_get("/v1/influxdb/health", self.handle_health)
        r.add_post("/v1/opentsdb/api/put", self.handle_opentsdb_put)
        r.add_post("/v1/prometheus/write", self.handle_prom_write)
        r.add_post("/v1/prometheus/read", self.handle_prom_read)
        r.add_get("/metrics", self.handle_metrics)
        r.add_get("/health", self.handle_health)
        r.add_get("/status", self.handle_status)
        r.add_get("/v1/trace/{trace_id}", self.handle_trace)
        r.add_post("/v1/admin/flush", self.handle_flush)
        r.add_post("/v1/admin/compact", self.handle_compact)
        r.add_post("/v1/admin/downsample", self.handle_downsample)
        r.add_route("*", "/v1/admin/failpoints", self.handle_failpoints)
        r.add_post("/v1/scripts", self.handle_scripts)
        r.add_post("/v1/run-script", self.handle_run_script)
        r.add_get("/v1/prof/mem", self.handle_mem_prof)
        r.add_get("/debug/prof/cpu", self.handle_cpu_prof)
        r.add_route("*", "/api/v1/query", self.handle_prom_api_query)
        r.add_route("*", "/api/v1/query_range", self.handle_prom_api_range)
        r.add_route("*", "/api/v1/labels", self.handle_prom_api_labels)
        r.add_route("*", "/api/v1/series", self.handle_prom_api_series)
        r.add_route("*", "/api/v1/label/{name}/values",
                    self.handle_prom_api_label_values)
        # Grafana/Prometheus compatibility probes
        r.add_get("/api/v1/status/buildinfo", self.handle_prom_buildinfo)
        r.add_route("*", "/api/v1/metadata", self.handle_prom_metadata)
        return app

    async def handle_prom_buildinfo(self, request):
        """Grafana probes this to detect the Prometheus flavor."""
        from .mysql import SERVER_VERSION
        return web.json_response({
            "status": "success",
            "data": {"version": "2.45.0",
                     "application": f"greptimedb-tpu {SERVER_VERSION}",
                     "revision": "", "branch": "", "buildUser": "",
                     "buildDate": "", "goVersion": ""}})

    async def handle_prom_metadata(self, request):
        """Metric metadata: every field column of every table, typed as
        untyped (the reference serves the same shape)."""
        ctx = self._ctx(request)
        out = {}
        catalog = ctx.current_catalog
        for schema_name in self.frontend.catalog.schema_names(catalog):
            for tname in self.frontend.catalog.table_names(catalog,
                                                           schema_name):
                t = self.frontend.catalog.table(catalog, schema_name,
                                                tname)
                if t is None:
                    continue
                out[tname] = [{"type": "untyped", "help": "", "unit": ""}]
        return web.json_response({"status": "success", "data": out})

    @web.middleware
    async def _error_middleware(self, request, handler):
        start = time.perf_counter()
        try:
            return await self._observed(request, handler, start)
        except AuthError as e:
            return web.json_response(
                {"code": int(StatusCode.USER_PASSWORD_MISMATCH),
                 "error": str(e)}, status=401)
        except GreptimeError as e:
            code = getattr(e, "status_code", StatusCode.INTERNAL)
            headers = None
            status = 400
            if code == StatusCode.RATE_LIMITED:
                # admission rejection: reject-with-retry-after, the
                # load-shedding contract (errors.py maps the code → 429)
                status = e.to_http_status()
                headers = {"Retry-After":
                           str(getattr(e, "retry_after_s", 1))}
            return web.json_response(
                {"code": int(code),
                 "error": str(e),
                 "execution_time_ms": int((time.perf_counter() - start) * 1e3)},
                status=status, headers=headers)
        except web.HTTPException:
            raise
        except Exception as e:  # pragma: no cover - defensive
            return web.json_response(
                {"code": int(StatusCode.INTERNAL), "error": str(e)},
                status=500)

    @staticmethod
    async def _observed(request, handler, start: float):
        """Per-route latency histogram (canonical route template, not
        the raw path, so /api/v1/label/{name}/values stays ONE series).
        Recorded in a finally so error responses — the requests an
        operator most needs in the distribution — count too."""
        try:
            return await handler(request)
        finally:
            resource = getattr(request.match_info.route, "resource", None)
            if resource is not None:
                from ..common.telemetry import observe_latency
                observe_latency("http_request",
                                time.perf_counter() - start,
                                route=resource.canonical)

    def _ctx(self, request) -> QueryContext:
        self.user_provider.auth_http_basic(
            request.headers.get("Authorization"))
        db = request.query.get("db") or request.headers.get("x-greptime-db")
        catalog, schema = parse_db_param(db)
        return QueryContext(catalog, schema, Channel.HTTP)

    def _traced_call(self, request, fn):
        """Run `fn` (on the executor thread) under the request's W3C
        `traceparent` header, so external clients can stitch the whole
        statement — frontend span, datanode RPCs, slow-query log lines —
        onto their own trace."""
        tp = request.headers.get("traceparent")

        def run():
            from ..common.telemetry import remote_context
            with remote_context(tp):
                return fn()
        return run

    async def _param(self, request, name: str) -> Optional[str]:
        if name in request.query:
            return request.query[name]
        if request.method == "POST":
            if request.content_type == "application/x-www-form-urlencoded":
                form = await request.post()
                if name in form:
                    return form[name]
            elif request.content_type in ("application/json",):
                try:
                    body = await request.json()
                    if isinstance(body, dict) and name in body:
                        return str(body[name])
                except ValueError:
                    # malformed client JSON: fall through to "parameter
                    # absent" — the handler's 400 names the parameter
                    return None
        return None

    # ---- handlers ----
    async def handle_sql(self, request):
        t0 = time.perf_counter()
        ctx = self._ctx(request)
        sql = await self._param(request, "sql")
        if not sql:
            return web.json_response(
                {"code": int(StatusCode.INVALID_ARGUMENTS),
                 "error": "missing 'sql' parameter"}, status=400)
        loop = asyncio.get_running_loop()
        outputs = await loop.run_in_executor(
            None,
            self._traced_call(request,
                              lambda: self.frontend.do_query(sql, ctx)))
        return web.json_response({
            "code": 0,
            "output": [output_to_json(o) for o in outputs],
            "execution_time_ms": int((time.perf_counter() - t0) * 1e3),
        })

    async def handle_promql(self, request):
        t0 = time.perf_counter()
        ctx = self._ctx(request)
        query = await self._param(request, "query")
        start = await self._param(request, "start")
        end = await self._param(request, "end")
        step = await self._param(request, "step")
        if not all([query, start, end, step]):
            return web.json_response(
                {"code": int(StatusCode.INVALID_ARGUMENTS),
                 "error": "query/start/end/step are required"}, status=400)
        from ..sql.ast import Tql
        loop = asyncio.get_running_loop()
        out = await loop.run_in_executor(
            None, self._traced_call(
                request, lambda: self.frontend.execute_tql(
                    Tql("eval", start, end, step, None, query), ctx)))
        return web.json_response({
            "code": 0,
            "output": [output_to_json(out)],
            "execution_time_ms": int((time.perf_counter() - t0) * 1e3),
        })

    # ---- coprocessor scripts (reference: /v1/scripts + /v1/run-script,
    # src/servers/src/http.rs:434-578 script routes) ----
    def _script_engine(self):
        engine = getattr(self.frontend, "script_engine", None)
        if engine is None:
            from ..script import ScriptEngine
            engine = ScriptEngine(self.frontend)
            self.frontend.script_engine = engine
        return engine

    async def handle_scripts(self, request):
        ctx = self._ctx(request)
        name = request.query.get("name")
        if request.query.get("db"):
            ctx.set_current_schema(request.query["db"])
        if not name:
            return web.json_response(
                {"code": int(StatusCode.INVALID_ARGUMENTS),
                 "error": "missing 'name' parameter"}, status=400)
        script = (await request.read()).decode()
        loop = asyncio.get_running_loop()
        engine = self._script_engine()
        await loop.run_in_executor(
            None, self._traced_call(
                request, lambda: engine.insert_script(name, script, ctx)))
        return web.json_response({"code": 0})

    async def handle_run_script(self, request):
        t0 = time.perf_counter()
        ctx = self._ctx(request)
        name = request.query.get("name")
        if request.query.get("db"):
            ctx.set_current_schema(request.query["db"])
        loop = asyncio.get_running_loop()
        engine = self._script_engine()
        if name:
            out = await loop.run_in_executor(
                None, self._traced_call(
                    request, lambda: engine.run(name, ctx=ctx)))
        else:
            script = (await request.read()).decode()
            if not script:
                return web.json_response(
                    {"code": int(StatusCode.INVALID_ARGUMENTS),
                     "error": "missing 'name' parameter or script body"},
                    status=400)
            out = await loop.run_in_executor(
                None, self._traced_call(
                    request, lambda: engine.run(script, ctx=ctx,
                                                is_script_text=True)))
        return web.json_response({
            "code": 0,
            "output": [output_to_json(out)],
            "execution_time_ms": int((time.perf_counter() - t0) * 1e3),
        })

    async def handle_influx_write(self, request):
        ctx = self._ctx_influx(request)
        precision = request.query.get("precision", "ns")
        body = (await request.read()).decode()
        loop = asyncio.get_running_loop()

        def work():
            from ..common.admission import GATE
            from .coalesce import COALESCER
            with GATE.admit_ingest(len(body)):
                inserts, tag_cols = influx_mod.body_to_inserts(body,
                                                               precision)
                n = 0
                for table, cols in inserts.items():
                    # concurrent small bodies for the same measurement
                    # merge into one shared bulk insert (one WAL record,
                    # one group-commit fsync) — the ack still covers
                    # exactly this request's rows
                    n += COALESCER.ingest(
                        self.frontend, table, cols,
                        tag_columns=tag_cols[table],
                        timestamp_column=influx_mod.GREPTIME_TIMESTAMP,
                        ctx=ctx)
                return n

        await loop.run_in_executor(None, self._traced_call(request, work))
        return web.Response(status=204)

    def _ctx_influx(self, request) -> QueryContext:
        # influxdb v1 auth: u/p params; v2: Token header; else basic
        u = request.query.get("u")
        p = request.query.get("p")
        if u is not None or p is not None:
            if not self.user_provider.authenticate(u or "", p or ""):
                raise AuthError("bad username or password")
        else:
            auth = request.headers.get("Authorization")
            if auth and auth.startswith("Token "):
                token = auth[len("Token "):]
                name, _, pwd = token.partition(":")
                if not self.user_provider.authenticate(name, pwd):
                    raise AuthError("bad token")
            else:
                self.user_provider.auth_http_basic(auth)
        db = request.query.get("db") or request.query.get("bucket")
        catalog, schema = parse_db_param(db)
        return QueryContext(catalog, schema, Channel.INFLUX)

    async def handle_opentsdb_put(self, request):
        ctx = self._ctx(request)
        raw = await request.read()
        loop = asyncio.get_running_loop()

        def work():
            from ..common.admission import GATE
            from .coalesce import COALESCER
            # reserve the RAW body size like the influx/prom handlers —
            # a short-metric-name flood must not slip a big JSON body
            # past the byte gate
            with GATE.admit_ingest(len(raw)):
                points = tsdb_mod.parse_http_put(json.loads(raw))
                inserts, tag_cols = tsdb_mod.points_to_inserts(points)
                for table, cols in inserts.items():
                    COALESCER.ingest(
                        self.frontend, table, cols,
                        tag_columns=tag_cols[table],
                        timestamp_column=tsdb_mod.GREPTIME_TIMESTAMP,
                        ctx=ctx)
                return len(points)

        n = await loop.run_in_executor(None,
                                       self._traced_call(request, work))
        return web.json_response({"success": n, "failed": 0}, status=200)

    async def handle_prom_write(self, request):
        ctx = self._ctx(request)
        body = await request.read()
        loop = asyncio.get_running_loop()

        def work():
            from ..common.admission import GATE
            from .coalesce import COALESCER
            with GATE.admit_ingest(len(body)):
                inserts, tag_cols = prom_mod.write_request_to_inserts(body)
                for table, cols in inserts.items():
                    COALESCER.ingest(
                        self.frontend, table, cols,
                        tag_columns=tag_cols[table],
                        timestamp_column=prom_mod.GREPTIME_TIMESTAMP,
                        ctx=ctx)

        await loop.run_in_executor(None, self._traced_call(request, work))
        return web.Response(status=204)

    async def handle_prom_read(self, request):
        ctx = self._ctx(request)
        body = await request.read()
        loop = asyncio.get_running_loop()

        def work():
            queries = prom_mod.decode_read_request(body)
            results = []
            for q in queries:
                results.append(self._remote_read_query(q, ctx))
            return prom_mod.encode_read_response(results)

        payload = await loop.run_in_executor(None,
                                             self._traced_call(request, work))
        return web.Response(body=payload,
                            content_type="application/x-protobuf",
                            headers={"Content-Encoding": "snappy"})

    def _remote_read_query(self, q, ctx) -> List[prom_mod.TimeSeries]:
        """Scan the metric table over [start, end] and re-assemble series
        (reference: prometheus.rs remote read → SQL)."""
        metric = q.metric_name()
        if metric is None:
            return []
        table = self.frontend.catalog.table(
            ctx.current_catalog, ctx.current_schema, metric)
        if table is None:
            return []
        from ..common.time import TimestampRange
        batches = table.scan_batches(
            time_range=TimestampRange(q.start_ms, q.end_ms + 1))
        tag_names = table.schema.tag_names()
        ts_name = table.schema.timestamp_column.name
        by_series: Dict[tuple, prom_mod.TimeSeries] = {}
        for b in batches:
            for row in b.to_pylist():
                labels = {t: str(row[t]) for t in tag_names if t in row}
                ok = True
                for m in q.matchers:
                    if m.name == prom_mod.METRIC_NAME_LABEL:
                        continue
                    if not m.matches(labels.get(m.name, "")):
                        ok = False
                        break
                if not ok:
                    continue
                key = tuple(sorted(labels.items()))
                s = by_series.get(key)
                if s is None:
                    full = dict(labels)
                    full[prom_mod.METRIC_NAME_LABEL] = metric
                    s = prom_mod.TimeSeries(labels=full)
                    by_series[key] = s
                val = row.get(prom_mod.GREPTIME_VALUE)
                if val is None:
                    fields = table.schema.field_names()
                    val = row.get(fields[0]) if fields else None
                if val is not None:
                    s.samples.append((float(val), int(row[ts_name])))
        return list(by_series.values())

    async def handle_trace(self, request):
        """GET /v1/trace/<trace_id> — the reassembled waterfall of one
        stored trace from greptime_private.trace_spans (the durable trace
        store). 'last' = the most recently retained trace on this
        frontend. 404 when the trace was sampled out, swept by retention,
        or never existed."""
        self.user_provider.auth_http_basic(
            request.headers.get("Authorization"))
        trace_id = request.match_info["trace_id"]

        def work():
            from ..common import trace_store
            clients = getattr(self.frontend, "clients", None)
            tid, rows = trace_store.sync_and_fetch(
                self.frontend.catalog, trace_id,
                clients=list(clients.values()) if clients else None)
            if not rows:
                return tid, None
            return tid, {
                "spans": rows,
                "waterfall": trace_store.waterfall_rows(rows),
            }

        loop = asyncio.get_running_loop()
        tid, doc = await loop.run_in_executor(
            None, self._traced_call(request, work))
        if doc is None:
            return web.json_response(
                {"code": int(StatusCode.INVALID_ARGUMENTS),
                 "error": f"trace {tid or trace_id!r} not found "
                          f"(sampled out, swept, or never existed)"},
                status=404)
        doc["trace_id"] = tid
        doc["span_count"] = len(doc["spans"])
        return web.json_response(doc)

    async def handle_cpu_prof(self, request):
        """GET /debug/prof/cpu?seconds=N&hz=H&format=folded|flamegraph|json
        — an on-demand high-rate CPU sampling burst (the reference's
        pprof-shaped /debug/prof/cpu, src/common/pprof). On a
        distributed frontend the burst fans out to every datanode over
        the Flight `profile` action concurrently and the folded stacks
        merge per node. Works with `SET profiling` off — the burst has
        its own clock and rate."""
        self.user_provider.auth_http_basic(
            request.headers.get("Authorization"))
        fmt = request.query.get("format", "folded")
        if fmt not in ("folded", "flamegraph", "json"):
            return web.json_response(
                {"code": int(StatusCode.INVALID_ARGUMENTS),
                 "error": f"format {fmt!r} not supported "
                          f"(folded | flamegraph | json)"}, status=400)
        try:
            seconds = float(request.query.get("seconds", "3"))
            hz = request.query.get("hz")
            hz_f = float(hz) if hz is not None else None
        except ValueError:
            return web.json_response(
                {"code": int(StatusCode.INVALID_ARGUMENTS),
                 "error": "seconds/hz must be numbers"}, status=400)

        def work():
            from ..common import profiler
            from ..common.runtime import parallel_map
            s = profiler.sampler()
            clients = list(getattr(self.frontend, "clients",
                                   {}).values())

            def one(target):
                try:
                    if target is None:
                        if s is None:
                            return []
                        return s.collect_burst(seconds, burst_hz=hz_f)
                    return target.profile(seconds=seconds, hz=hz_f)
                except Exception as e:  # noqa: BLE001 — a dead node
                    logger.warning(     # must not void the whole burst
                        "profile burst fan-out failed: %s", e)
                    return []

            merged: list = []
            for rows in parallel_map(one, [None] + clients,
                                     max_workers=len(clients) + 1):
                merged.extend(rows or [])
            return merged

        loop = asyncio.get_running_loop()
        rows = await loop.run_in_executor(
            None, self._traced_call(request, work))
        from ..common import profiler as prof_mod
        if fmt == "folded":
            return web.Response(text=prof_mod.folded_text(rows),
                                content_type="text/plain")
        if fmt == "flamegraph":
            return web.Response(
                text=prof_mod.flamegraph_svg(
                    rows, title=f"cpu {seconds:g}s burst"),
                content_type="image/svg+xml")
        return web.json_response({
            "seconds": seconds,
            "sample_count": sum(int(r.get("count") or 0) for r in rows),
            "rows": rows,
        })

    async def handle_mem_prof(self, request):
        """Heap profile dump (reference: jemalloc /v1/prof/mem,
        src/common/mem-prof; here a tracemalloc top-N snapshot). The
        first call enables tracing — subsequent calls diff against it."""
        import tracemalloc
        if not tracemalloc.is_tracing():
            tracemalloc.start()
            return web.Response(
                text="tracemalloc started; call again for a snapshot\n")
        snapshot = tracemalloc.take_snapshot()
        top = snapshot.statistics("lineno")[:50]
        lines = [f"{stat.size / 1024:.1f} KiB in {stat.count} blocks: "
                 f"{stat.traceback}" for stat in top]
        total = sum(s.size for s in snapshot.statistics("filename"))
        lines.insert(0, f"total traced: {total / 1048576:.2f} MiB")
        return web.Response(text="\n".join(lines) + "\n")

    async def handle_metrics(self, request):
        try:
            from prometheus_client import generate_latest
        except ImportError:  # pragma: no cover
            return web.Response(text="")
        from ..common.telemetry import registry
        return web.Response(body=generate_latest(registry()),
                            content_type="text/plain")

    async def handle_health(self, request):
        return web.json_response({})

    async def handle_status(self, request):
        """Server status: version, uptime, region count, cache health and
        the latest ingest/scan stage profiles (reference: the /status
        build+state handler, src/servers/src/http/handler.rs) — the quick
        'what is this node doing' view the observability tests assert."""
        from .. import __version__
        regions = []
        try:
            cat = self.frontend.catalog
            for schema_name in cat.schema_names(DEFAULT_CATALOG_NAME):
                for tname in cat.table_names(DEFAULT_CATALOG_NAME,
                                             schema_name):
                    t = cat.table(DEFAULT_CATALOG_NAME, schema_name,
                                  tname)
                    regions.extend(
                        getattr(t, "regions", {}).values())
        except Exception:  # noqa: BLE001 — status must never 500
            from ..common.telemetry import increment_counter
            increment_counter("status_partial")
        ingest = scan = None
        for r in regions:
            p = getattr(r, "last_ingest_profile", None)
            if p is not None:
                ingest = p.describe()
            p = getattr(r, "last_scan_profile", None)
            if p is not None:
                scan = p.describe()
        from ..query.tpu_exec import SCAN_CACHE
        store = getattr(self.frontend.datanode, "store", None) \
            if hasattr(self.frontend, "datanode") else None
        ratio = store.hit_ratio() if hasattr(store, "hit_ratio") else None
        # degraded-mode health: regions whose background flush/compaction
        # has been failing, and the fault-injection state (robustness PR)
        background_errors = {}
        for r in regions:
            errs = getattr(r, "bg_errors", None)
            if errs:
                background_errors[r.name] = errs
        from ..common import failpoint
        from ..common.admission import GATE
        return web.json_response({
            "version": __version__,
            "admission": GATE.snapshot(),
            "uptime_s": round(time.time() - self._start_time, 3),
            "region_count": len(regions),
            "read_cache_hit_ratio": ratio,
            "scan_cache_resident_bytes": SCAN_CACHE.resident_bytes(),
            "last_ingest_profile": ingest,
            "last_scan_profile": scan,
            "background_errors": background_errors,
            "failpoints_active": failpoint.active_count(),
        })

    async def handle_flush(self, request):
        ctx = self._ctx(request)
        table_name = request.query.get("table")
        loop = asyncio.get_running_loop()

        def work():
            cat = self.frontend.catalog
            names = [table_name] if table_name else \
                cat.table_names(ctx.current_catalog, ctx.current_schema)
            for name in names:
                t = cat.table(ctx.current_catalog, ctx.current_schema, name)
                if t is not None:
                    t.flush()

        await loop.run_in_executor(None,
                                   self._traced_call(request, work))
        return web.json_response({"code": 0})

    async def handle_compact(self, request):
        ctx = self._ctx(request)
        table_name = request.query.get("table")
        loop = asyncio.get_running_loop()

        def work():
            cat = self.frontend.catalog
            names = [table_name] if table_name else \
                cat.table_names(ctx.current_catalog, ctx.current_schema)
            for name in names:
                t = cat.table(ctx.current_catalog, ctx.current_schema, name)
                for region in getattr(t, "regions", {}).values():
                    region.compact()

        await loop.run_in_executor(None,
                                   self._traced_call(request, work))
        return web.json_response({"code": 0})

    async def handle_failpoints(self, request):
        """Fault-injection admin surface (common/failpoint.py):

        - GET  /v1/admin/failpoints                  — list points
        - POST /v1/admin/failpoints?name=X&action=A  — arm (A='off' clears)
        - DELETE /v1/admin/failpoints[?name=X]       — disarm one / all
        """
        from ..common import failpoint
        self.user_provider.auth_http_basic(
            request.headers.get("Authorization"))
        if request.method == "GET":
            return web.json_response({"code": 0,
                                      "failpoints": failpoint.list_points()})
        if request.method == "DELETE":
            name = request.query.get("name")
            if name:
                try:
                    failpoint.configure(name, None)
                except ValueError as e:
                    return web.json_response(
                        {"code": int(StatusCode.INVALID_ARGUMENTS),
                         "error": str(e)}, status=400)
            else:
                failpoint.clear_all()
            return web.json_response({"code": 0})
        if request.method != "POST":
            return web.json_response(
                {"code": int(StatusCode.INVALID_ARGUMENTS),
                 "error": f"unsupported method {request.method}"},
                status=405)
        name = await self._param(request, "name")
        action = await self._param(request, "action")
        if not name:
            return web.json_response(
                {"code": int(StatusCode.INVALID_ARGUMENTS),
                 "error": "missing 'name' parameter"}, status=400)
        if not action:
            # a bare POST must not silently disarm a live experiment —
            # DELETE is the disarm surface
            return web.json_response(
                {"code": int(StatusCode.INVALID_ARGUMENTS),
                 "error": "missing 'action' parameter ('off' or DELETE "
                          "disarms)"}, status=400)
        try:
            failpoint.configure(name, action)
        except ValueError as e:
            return web.json_response(
                {"code": int(StatusCode.INVALID_ARGUMENTS),
                 "error": str(e)}, status=400)
        return web.json_response({"code": 0})

    async def handle_downsample(self, request):
        """POST /v1/admin/downsample?src=raw&dst=agg&stride=60s[&agg=avg]
        — aggregate src's rows into stride buckets and append to dst (the
        device-resident maintenance job, storage/downsample.py). This
        build's extension over the reference (v0.2 compaction only
        merges files)."""
        from ..common.time import parse_duration_ms
        from ..storage.downsample import downsample_region
        ctx = self._ctx(request)
        src_name = request.query.get("src")
        dst_name = request.query.get("dst")
        stride = request.query.get("stride", "60s")
        agg = request.query.get("agg", "avg")
        if not src_name or not dst_name:
            return web.json_response(
                {"code": 1004, "error": "src and dst are required"},
                status=400)
        try:
            stride_ms = parse_duration_ms(stride)
        except (ValueError, TypeError):
            return web.json_response(
                {"code": 1004, "error": f"bad stride {stride!r}"},
                status=400)
        cat = self.frontend.catalog
        src = cat.table(ctx.current_catalog, ctx.current_schema, src_name)
        dst = cat.table(ctx.current_catalog, ctx.current_schema, dst_name)
        if src is None or dst is None:
            return web.json_response(
                {"code": 4001, "error": "src or dst table not found"},
                status=404)
        loop = asyncio.get_running_loop()

        def work():
            total = 0
            src_regions = list(getattr(src, "regions", {}).values())
            dst_regions = list(getattr(dst, "regions", {}).values())
            if not src_regions or not dst_regions:
                raise ValueError("downsample needs region-backed tables")
            fields = [c.name for c in src.schema.field_columns()
                      if not src.schema.column_schema(c.name)
                      .dtype.is_string]
            aggs = {f: agg for f in fields}
            for region in src_regions:
                # destination rows go through the TABLE so a partitioned
                # dst routes each bucket row to its region via the
                # partition rule (partition/splitter.py); this endpoint
                # stays the manual backfill path for flows
                total += downsample_region(
                    region, dst, stride_ms=stride_ms, aggs=aggs,
                    device=self.frontend.query_engine.device)
            return total

        try:
            rows = await loop.run_in_executor(
                None, self._traced_call(request, work))
        except Exception as e:  # noqa: BLE001 — surface as API error
            return web.json_response({"code": 1004, "error": str(e)},
                                     status=400)
        return web.json_response({"code": 0, "rows_written": rows})

    # ---- Prometheus HTTP API (prom.rs) ----
    async def handle_prom_api_query(self, request):
        from .prom_api import instant_query
        return await instant_query(self, request)

    async def handle_prom_api_range(self, request):
        from .prom_api import range_query
        return await range_query(self, request)

    async def handle_prom_api_labels(self, request):
        from .prom_api import labels_query
        return await labels_query(self, request)

    async def handle_prom_api_series(self, request):
        from .prom_api import series_query
        return await series_query(self, request)

    async def handle_prom_api_label_values(self, request):
        from .prom_api import label_values_query
        return await label_values_query(self, request)

    # ---- lifecycle (thread-hosted event loop) ----
    def start(self) -> None:
        from ..common.runtime import new_thread
        self._thread = new_thread(self._run, daemon=True,
                                  name="http-server",
                                  propagate_context=False)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("http server failed to start")

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def boot():
            app = self.make_app()
            self._runner = web.AppRunner(app)
            await self._runner.setup()
            site = web.TCPSite(self._runner, self.host, self.port,
                               ssl_context=self.ssl_context)
            await site.start()
            if self.port == 0:
                self.port = self._runner.addresses[0][1]
            self._started.set()

        loop.run_until_complete(boot())
        loop.run_forever()

    def shutdown(self) -> None:
        if self._loop is None:
            return

        async def stop():
            if self._runner is not None:
                await self._runner.cleanup()
            asyncio.get_event_loop().stop()

        self._loop.call_soon_threadsafe(
            lambda: asyncio.ensure_future(stop()))
        if self._thread is not None:
            self._thread.join(timeout=5)
