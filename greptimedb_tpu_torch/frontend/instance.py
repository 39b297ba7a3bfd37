"""FrontendInstance: the handler all protocol servers call into.

Reference behavior: src/frontend/src/instance.rs — implements
`SqlQueryHandler` (do_query), auto create/alter-on-insert for protocol
ingest (instance.rs:281-342), and wires the statement executor + query
engine. In standalone mode it sits directly on an in-process datanode
(instance.rs:200-222).

Ported from greptimedb_tpu/frontend/instance.py for the standalone
deployment; queries run on the datanode's device. `do_query` admits
each statement through the admission gate (common/admission.py) and
consults the `SqlQueryInterceptor` in `plugins` (servers/interceptor.py),
in the reference's order; KILL trips the process registry
(`statement.apply_kill`), which the MySQL and Postgres servers also
reach. As the reference's standalone frontend does, it builds and
installs the self-monitor (monitor/), the durable trace store's sink
(common/trace_store.py) and the continuous profiler
(common/profiler.py), answers ADMIN SHOW TRACE / SHOW PROFILE, and
loads the persisted coprocessor scripts (script/) in `start()`, whose
bodies run on the frontend's device. TQL and the Prometheus API's
queries go to `promql_engine()`, over the same catalog.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence

from ..datanode import DatanodeInstance
from ..datatypes.data_type import (
    BOOLEAN, ConcreteDataType, FLOAT64, INT64, STRING, TIMESTAMP_MILLISECOND)
from ..datatypes.schema import ColumnSchema, Schema, SemanticType
from ..errors import (
    InvalidArgumentsError, TableAlreadyExistsError, UnsupportedError)
from ..query.output import Output
from ..session import QueryContext
from ..sql import ast, parse_statements
from ..table.requests import (
    AddColumnRequest, AlterKind, AlterTableRequest, CreateTableRequest)
from .statement import (StatementExecutor, apply_admin_maintenance,
                        apply_kill, apply_show_profile, apply_show_trace)

GREPTIME_TIMESTAMP = "greptime_timestamp"
GREPTIME_VALUE = "greptime_value"

#: dedicated logger so operators can route/filter the slow-query log
#: independently (reference: the slow_query appender in common-telemetry)
_slow_logger = logging.getLogger("greptimedb_tpu_torch.slow_query")


class FrontendInstance:
    def __init__(self, datanode: DatanodeInstance):
        self.datanode = datanode
        self.catalog = datanode.catalog
        self.query_engine = datanode.query_engine
        self._tql_engine = None
        from ..common.plugins import Plugins
        self.plugins = Plugins()
        self.statement_executor = StatementExecutor(
            self.catalog, datanode.engines, self.query_engine,
            procedure_manager=datanode.procedure_manager,
            flow_manager=datanode.flow_manager)
        self.script_engine = None
        # self-monitoring: the scraper walks the port's telemetry
        # registry + per-region heat and writes both through
        # handle_row_insert into greptime_private system tables
        # (monitor/scraper.py)
        from ..common import (background_jobs, process_list, profiler,
                              trace_store)
        from ..monitor import SelfMonitor
        self.self_monitor = SelfMonitor(self, node_label="standalone")
        self.catalog.self_monitor = self.self_monitor
        process_list.configure_node("standalone")
        background_jobs.configure_node("standalone")
        # durable trace store: completed spans buffer in the sink; the
        # tail verdict fires at trace completion (this process roots its
        # statements' traces) and retained spans flush through
        # handle_row_insert into greptime_private.trace_spans
        self.trace_sink = trace_store.TraceSink(
            node_label="standalone", service="standalone", role="root",
            writer=self)
        trace_store.install(self.trace_sink)
        self.catalog.trace_sink = self.trace_sink
        # continuous profiler: folded stacks aggregate in-process and
        # flush on the self-monitor tick into
        # greptime_private.profile_samples (SET profiling = 1 arms it)
        self.profiler = profiler.Profiler(node_label="standalone",
                                          writer=self)
        profiler.install(self.profiler)

    def start(self) -> None:
        if not self.datanode._started:
            self.datanode.start()
        # recompile + re-register persisted coprocessors (reference:
        # scripts system table, src/script/src/table.rs:51)
        from ..script import ScriptEngine
        self.script_engine = ScriptEngine(self)
        self.script_engine.load_scripts()
        # free-running scrape tick only outside pytest (tests drive
        # tick() cooperatively, as flows are)
        interval = self.datanode.opts.self_monitor_interval_s
        if interval > 0 and "PYTEST_CURRENT_TEST" not in os.environ:
            self.self_monitor.start_background(interval)

    def shutdown(self) -> None:
        self.self_monitor.stop()
        self.profiler.stop(join=False)
        self.datanode.shutdown()

    # ---- SqlQueryHandler ----
    def do_query(self, sql: str, ctx: Optional[QueryContext] = None
                 ) -> List[Output]:
        ctx = ctx or QueryContext()
        interceptor = self._interceptor()
        if interceptor is not None:
            sql = interceptor.pre_parsing(sql, ctx)
        stmts = parse_statements(sql)
        if interceptor is not None:
            stmts = interceptor.post_parsing(stmts, ctx)
        from ..common import process_list
        from ..common.admission import GATE as _admission
        from ..common.telemetry import (
            increment_counter, observe_latency, slow_query_threshold_ms,
            span, timer)
        outputs = []
        for s in stmts:
            # admission gate: reject-with-retry-after past the in-flight
            # limit (KILL/SET stay admitted — the operator's way out)
            _admission.admit_statement(type(s).__name__)
            if interceptor is not None:
                interceptor.pre_execute(s, ctx)
            t0 = time.perf_counter()
            prev_stats = self.query_engine.last_exec_stats
            try:
                with span("execute_stmt", stmt=type(s).__name__,
                          channel=ctx.channel.value) as sp, \
                        timer("stmt_execute"), \
                        process_list.track(
                            sql, protocol=ctx.channel.value,
                            catalog=ctx.current_catalog,
                            schema=ctx.current_schema,
                            trace_id=sp["trace_id"]):
                    out = self.execute_stmt(s, ctx)
            finally:
                # log-bucketed latency distribution per statement kind ×
                # protocol, recorded in a finally: statements that stall
                # then RAISE are the ones an operator most needs in it
                observe_latency(
                    "stmt_latency",
                    time.perf_counter() - t0,
                    stmt=type(s).__name__, protocol=ctx.channel.value)
            increment_counter(f"stmt_{type(s).__name__.lower()}")
            elapsed_ms = (time.perf_counter() - t0) * 1e3
            thr = slow_query_threshold_ms()
            if thr is not None and elapsed_ms >= thr:
                # only attach ExecStats THIS statement produced — a slow
                # DDL/DML or plain EXPLAIN (which never collects) must
                # not report the previous SELECT's stages
                stats = self.query_engine.last_exec_stats
                if stats is prev_stats:
                    stats = None
                # trace_stored makes the WARN a working pointer: 'yes'
                # means ADMIN SHOW TRACE '<trace>' can replay it later
                from ..common import profiler, trace_store
                sink = trace_store.sink()
                _slow_logger.warning(
                    "slow query: %.1fms (threshold %dms) trace=%s "
                    "trace_stored=%s%s stmt=%r stats=[%s]", elapsed_ms,
                    thr, sp["trace_id"],
                    sink.stored_verdict(sp["trace_id"])
                    if sink is not None else "off",
                    profiler.slow_query_suffix(sp["trace_id"]), sql,
                    stats.summary() if stats is not None else "n/a")
            if interceptor is not None:
                out = interceptor.post_execute(out, ctx)
            outputs.append(out)
        return outputs

    def _interceptor(self):
        """Plugin chain hook (reference: SqlQueryInterceptor consulted by
        every protocol frontend, src/servers/src/interceptor.rs:26)."""
        from ..servers.interceptor import SqlQueryInterceptor
        return self.plugins.get(SqlQueryInterceptor)

    def execute_stmt(self, stmt: ast.Statement, ctx: QueryContext) -> Output:
        ex = self.statement_executor
        if isinstance(stmt, ast.CreateTable):
            return ex.create_table(stmt, ctx)
        if isinstance(stmt, ast.CreateDatabase):
            return ex.create_database(stmt, ctx)
        if isinstance(stmt, ast.DropTable):
            return ex.drop_table(stmt, ctx)
        if isinstance(stmt, ast.DropDatabase):
            return ex.drop_database(stmt, ctx)
        if isinstance(stmt, ast.AlterTable):
            return ex.alter_table(stmt, ctx)
        if isinstance(stmt, ast.TruncateTable):
            return ex.truncate_table(stmt, ctx)
        if isinstance(stmt, ast.Insert):
            return ex.insert(stmt, ctx)
        if isinstance(stmt, ast.Delete):
            return ex.delete(stmt, ctx)
        if isinstance(stmt, ast.CreateFlow):
            return ex.create_flow(stmt, ctx)
        if isinstance(stmt, ast.DropFlow):
            return ex.drop_flow(stmt, ctx)
        if isinstance(stmt, ast.ShowFlows):
            return ex.show_flows(stmt, ctx)
        if isinstance(stmt, ast.Use):
            return ex.use_database(stmt, ctx)
        if isinstance(stmt, ast.SetVariable):
            return ex.set_variable(stmt, ctx)
        if isinstance(stmt, ast.Kill):
            return apply_kill(stmt)
        if isinstance(stmt, ast.Admin):
            if stmt.kind in ("flush_table", "compact_table"):
                return apply_admin_maintenance(self.catalog, stmt, ctx)
            if stmt.kind == "show_trace":
                return apply_show_trace(self.catalog, stmt)
            if stmt.kind == "show_profile":
                return apply_show_profile(self.catalog, stmt)
            # region placement is a cluster concept: standalone's single
            # implicit node has nothing to migrate/split between
            raise UnsupportedError(
                "ADMIN region operations require a distributed "
                "deployment (metasrv + datanodes)")
        if isinstance(stmt, ast.Copy):
            return ex.copy(stmt, ctx)
        if isinstance(stmt, ast.Tql):
            return self.execute_tql(stmt, ctx)
        return self.query_engine.execute(stmt, ctx)

    def promql_engine(self):
        """Lazily-built, shared PromQL engine (TQL and the Prometheus
        API), on the datanode's device."""
        if self._tql_engine is None:
            from ..promql.engine import PromqlEngine
            self._tql_engine = PromqlEngine(self.catalog,
                                            device=self.query_engine.device)
        return self._tql_engine

    def execute_tql(self, stmt: ast.Tql, ctx: QueryContext) -> Output:
        return self.promql_engine().execute_tql(stmt, ctx)

    # ---- protocol ingest: auto create / alter on demand ----
    def handle_row_insert(
        self, table_name: str, columns: Dict[str, Sequence],
        *, tag_columns: Sequence[str] = (),
        timestamp_column: str = GREPTIME_TIMESTAMP,
        types: Optional[Dict[str, ConcreteDataType]] = None,
        ctx: Optional[QueryContext] = None,
    ) -> int:
        """Insert with auto table create / auto column add (reference:
        create_or_alter_table_on_demand, src/frontend/src/instance.rs:292)."""
        ctx = ctx or QueryContext()
        catalog, schema_name = ctx.current_catalog, ctx.current_schema
        table = self.catalog.table(catalog, schema_name, table_name)
        types = types or {}
        if table is None:
            table = self._create_on_demand(
                catalog, schema_name, table_name, columns, tag_columns,
                timestamp_column, types)
        # a concurrent protocol auto-create may have won the race with a
        # NARROWER shape: alter-on-demand against the adopted table so
        # this request's field columns exist
        self._alter_on_demand(table, catalog, schema_name, table_name,
                              columns, types, tag_columns)
        # re-fetch for the post-alter schema; a concurrent DROP may have
        # emptied the slot — keep the handle we hold (its closed region
        # raises a clean taxonomy error, not AttributeError on None)
        table = self.catalog.table(catalog, schema_name, table_name) \
            or table
        return table.insert(columns)

    def handle_bulk_load(
        self, table_name: str, columns: Dict[str, Sequence],
        *, tag_columns: Sequence[str] = (),
        timestamp_column: str = GREPTIME_TIMESTAMP,
        types: Optional[Dict[str, ConcreteDataType]] = None,
        ctx: Optional[QueryContext] = None,
    ) -> int:
        """WAL-less bulk ingest: same auto create/alter as row insert, but
        routed through the engine's direct-to-SST load
        (MitoTable.bulk_load) when available. Durability comes from the
        SSTs + one manifest edit (reference: direct part writes,
        src/storage/src/region/writer.rs:394-433)."""
        ctx = ctx or QueryContext()
        catalog, schema_name = ctx.current_catalog, ctx.current_schema
        table = self.catalog.table(catalog, schema_name, table_name)
        types = types or {}
        if table is None:
            table = self._create_on_demand(
                catalog, schema_name, table_name, columns, tag_columns,
                timestamp_column, types)
        else:
            self._alter_on_demand(table, catalog, schema_name, table_name,
                                  columns, types, tag_columns)
            table = self.catalog.table(catalog, schema_name, table_name)
        bulk = getattr(table, "bulk_load", None)
        return bulk(columns) if bulk is not None else table.insert(columns)

    def _create_on_demand(self, catalog, schema_name, table_name, columns,
                          tag_columns, timestamp_column, types):
        schema, pk = build_ingest_schema(columns, tag_columns,
                                         timestamp_column, types)
        engine = self.datanode.mito
        table = engine.create_table(CreateTableRequest(
            table_name, schema, catalog_name=catalog,
            schema_name=schema_name, primary_key_indices=pk,
            create_if_not_exists=True))
        try:
            self.catalog.register_table(catalog, schema_name, table_name,
                                        table)
        except TableAlreadyExistsError:
            # concurrent auto-create race: a sibling protocol request
            # registered first — adopt its table (the engine-level create
            # was already if-not-exists, only the catalog insert raced)
            existing = self.catalog.table(catalog, schema_name, table_name)
            if existing is not None:
                return existing
            raise
        return table

    def _alter_on_demand(self, table, catalog, schema_name, table_name,
                         columns, types, tag_columns=()):
        missing = [name for name in columns
                   if not table.schema.contains(name)]
        if not missing:
            return
        new_tags = [n for n in missing if n in set(tag_columns)]
        if new_tags:
            # a new label cannot be added as a FIELD: distinct series that
            # differ only in it would collapse onto one (row key unchanged)
            # and MVCC dedup would silently drop samples. The series
            # dictionary is immutable post-create, so reject the write.
            raise InvalidArgumentsError(
                f"table {table_name!r} has no tag column(s) {new_tags}; "
                f"tags cannot be added after create — write to a new table "
                f"or recreate with the full label set")
        adds = [AddColumnRequest(ColumnSchema(
            name, infer_ingest_type(name, columns[name], types, "")))
            for name in missing]
        engine = self.datanode.engines[table.info.meta.engine]
        engine.alter_table(AlterTableRequest(
            table_name, AlterKind.ADD_COLUMNS, catalog_name=catalog,
            schema_name=schema_name, add_columns=adds))


def infer_ingest_type(name: str, values: Sequence,
                      types: Dict[str, ConcreteDataType],
                      timestamp_column: str) -> ConcreteDataType:
    """Column type inference for protocol ingest."""
    if name in types:
        return types[name]
    if name == timestamp_column:
        return TIMESTAMP_MILLISECOND
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            return BOOLEAN
        if isinstance(v, int):
            return INT64
        if isinstance(v, float):
            return FLOAT64
        if isinstance(v, str):
            return STRING
    return FLOAT64


def build_ingest_schema(columns, tag_columns, timestamp_column, types):
    """(Schema, pk_indices) for auto-created ingest tables: stable
    tags → timestamp → fields layout (reference column order)."""
    cols = []
    tag_set = set(tag_columns)
    for name, values in columns.items():
        dtype = infer_ingest_type(name, values, types or {},
                                  timestamp_column)
        if name == timestamp_column:
            cols.append(ColumnSchema(name, dtype, nullable=False,
                                     semantic_type=SemanticType.TIMESTAMP))
        elif name in tag_set:
            cols.append(ColumnSchema(name, dtype, nullable=False,
                                     semantic_type=SemanticType.TAG))
        else:
            cols.append(ColumnSchema(name, dtype))
    cols.sort(key=lambda c: {SemanticType.TAG: 0,
                             SemanticType.TIMESTAMP: 1,
                             SemanticType.FIELD: 2}[c.semantic_type])
    schema = Schema(cols)
    pk = [i for i, c in enumerate(cols)
          if c.semantic_type == SemanticType.TAG]
    return schema, pk


def build_standalone(opts=None) -> FrontendInstance:
    """Compose a standalone instance: frontend on an in-process datanode
    (reference: src/cmd/src/standalone.rs:317-350). The query engine runs
    on `opts.device`, "cuda" unless the caller asks for "cpu"."""
    from ..datanode import DatanodeOptions
    dn = DatanodeInstance(opts or DatanodeOptions())
    fe = FrontendInstance(dn)
    fe.start()
    return fe
