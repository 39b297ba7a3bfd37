"""Statement executor: DDL + DML statements.

Reference behavior: src/frontend/src/statement.rs + the datanode SQL
handlers (src/datanode/src/sql/*.rs): CREATE/DROP/ALTER TABLE, CREATE/DROP
DATABASE, INSERT, DELETE, USE, SET, TRUNCATE.

Ported from greptimedb_tpu/frontend/statement.py. DDL runs through the
procedure manager when the datanode has one; CREATE / DROP / SHOW FLOW
go to the datanode's FlowManager (flow/); CREATE EXTERNAL TABLE goes to
the file-table engine (file_table/); COPY TO / FROM reads and writes
parquet, csv and json files (gzip / zstd through common/datasource.py),
COPY FROM through the table's bulk load; KILL (`apply_kill`) trips the
port's process registry. Not ported yet, and raising UnsupportedError:
ADMIN SHOW TRACE / SHOW PROFILE (the trace store and the profiler).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import pandas as pd

from ..catalog import CatalogManager
from ..common.datasource import (file_codec, open_compressed_in,
                                 open_compressed_out)
from ..datatypes.data_type import parse_type_name
from ..datatypes.schema import (
    ColumnDefaultConstraint, ColumnSchema, Schema, SemanticType)
from ..errors import (
    DatabaseAlreadyExistsError, DatabaseNotFoundError, InvalidArgumentsError,
    TableNotFoundError, UnsupportedError)
from ..query.expr import Evaluator
from ..query.output import Output
from ..session import QueryContext
from ..sql import ast
from ..table.requests import (
    AddColumnRequest, AlterKind, AlterTableRequest, CreateTableRequest,
    DropTableRequest)
from ..table.table import TableEngine


def build_column_schema(col: ast.ColumnDef, *, is_tag: bool,
                        is_time_index: bool) -> ColumnSchema:
    dtype = parse_type_name(col.type_name)
    semantic = SemanticType.FIELD
    if is_time_index:
        semantic = SemanticType.TIMESTAMP
        if not dtype.is_timestamp:
            raise InvalidArgumentsError(
                f"TIME INDEX column {col.name!r} must be a timestamp type")
    elif is_tag:
        semantic = SemanticType.TAG
    default = None
    if col.default is not None:
        d = col.default
        if isinstance(d, ast.FunctionCall) and d.name in (
                "current_timestamp", "now"):
            default = ColumnDefaultConstraint(function="current_timestamp")
        elif isinstance(d, ast.Literal):
            default = ColumnDefaultConstraint(value=d.value)
        elif isinstance(d, ast.UnaryOp) and d.op == "-" and \
                isinstance(d.operand, ast.Literal):
            default = ColumnDefaultConstraint(value=-d.operand.value)
        else:
            raise InvalidArgumentsError(
                f"unsupported default expression for {col.name!r}")
    nullable = col.nullable and not is_time_index and not is_tag
    return ColumnSchema(col.name, dtype, nullable=nullable,
                        semantic_type=semantic, default=default,
                        comment=col.comment or "")


def build_schema_from_create(stmt: ast.CreateTable):
    """CREATE TABLE statement → (Schema, primary-key indices)."""
    pk = set(stmt.primary_keys)
    cols = []
    for c in stmt.columns:
        cols.append(build_column_schema(
            c, is_tag=c.name in pk,
            is_time_index=c.name == stmt.time_index))
    schema = Schema(cols)
    pk_indices = [i for i, c in enumerate(cols)
                  if c.semantic_type == SemanticType.TAG]
    return schema, pk_indices


def show_flows_output(flow_manager, stmt: ast.ShowFlows,
                      ctx: QueryContext) -> Output:
    """SHOW FLOWS rendering. The `watermark` column carries
    wall-advancing fold state; the sqlness runner normalizes it in
    goldens."""
    import re

    from ..datatypes import data_type as dt
    from ..datatypes.record_batch import RecordBatch
    from ..query.expr import like_to_regex

    flows = flow_manager.flows(ctx.current_catalog, ctx.current_schema)
    if stmt.like:
        rx = re.compile(like_to_regex(stmt.like))
        flows = [f for f in flows if rx.match(f.name)]
    schema = Schema([
        ColumnSchema("flow_name", dt.STRING),
        ColumnSchema("source", dt.STRING),
        ColumnSchema("sink", dt.STRING),
        ColumnSchema("stride_ms", dt.INT64),
        ColumnSchema("aggs", dt.STRING),
        ColumnSchema("watermark", dt.INT64, nullable=True),
        ColumnSchema("rows_folded", dt.INT64),
    ])
    rb = RecordBatch.from_pydict(schema, {
        "flow_name": [f.name for f in flows],
        "source": [f.source for f in flows],
        "sink": [f.sink for f in flows],
        "stride_ms": [f.stride_ms for f in flows],
        "aggs": [", ".join(a.describe() for a in f.aggs) for f in flows],
        "watermark": [f.watermark_ts() for f in flows],
        "rows_folded": [f.stats.get("rows_folded", 0) for f in flows],
    })
    return Output.record_batches([rb], schema)


def evaluate_insert_rows(stmt: ast.Insert, columns, query_engine, ctx
                         ) -> dict:
    """INSERT VALUES/SELECT → column dict (shared by the standalone and
    distributed executors)."""
    if stmt.select is not None:
        out = query_engine.execute_query(stmt.select, ctx)
        rows = [list(r) for b in out.batches for r in b.rows()]
    else:
        ev = None
        rows = []
        for row in stmt.rows:
            if len(row) != len(columns):
                raise InvalidArgumentsError(
                    f"insert row has {len(row)} values, expected "
                    f"{len(columns)}")
            vals = []
            for e in row:
                # literal fast path: bulk VALUES lists are literals;
                # only expressions (now(), 1+2, ...) hit the evaluator
                if type(e) is ast.Literal:
                    vals.append(e.value)
                    continue
                if ev is None:
                    ev = Evaluator(pd.DataFrame(index=[0]))
                v = ev.eval(e)
                if isinstance(v, pd.Series):
                    v = v.iloc[0]
                vals.append(v)
            rows.append(vals)
    return {c: [r[i] for r in rows] for i, c in enumerate(columns)}


def delete_matching_rows(table, stmt: ast.Delete) -> Output:
    """DELETE ... WHERE: scan key columns, filter, delete by key (shared by
    the standalone and distributed executors)."""
    schema = table.schema
    tc = schema.timestamp_column
    key_cols = schema.tag_names() + ([tc.name] if tc else [])
    batches = table.scan_batches(projection=key_cols)
    frames = [pd.DataFrame(b.to_pydict()) for b in batches]
    df = pd.concat(frames, ignore_index=True) if frames else \
        pd.DataFrame(columns=key_cols)
    if stmt.where is not None and len(df):
        mask = Evaluator(df).eval(stmt.where)
        if isinstance(mask, pd.Series):
            df = df[mask.fillna(False).astype(bool)]
        elif not mask:
            df = df.iloc[0:0]
    if not len(df):
        return Output.rows(0)
    df = df.drop_duplicates()
    table.delete({c: df[c].tolist() for c in key_cols})
    return Output.rows(len(df))


def _int_setting(stmt: ast.SetVariable) -> int:
    try:
        return int(stmt.value)
    except (TypeError, ValueError):
        raise InvalidArgumentsError(
            f"SET {stmt.name}: expected an integer, got {stmt.value!r}")


def apply_kill(stmt: ast.Kill) -> Output:
    """Shared KILL handler: trip the cancel event of a running statement
    in the process-wide registry. The killed statement raises
    QueryCancelledError at its next batch boundary; an unknown or
    already-finished id is a clean InvalidArgumentsError (the registry
    raises it), never a crash."""
    from ..common import process_list
    process_list.REGISTRY.kill(stmt.process_id)
    return Output.rows(1)


def apply_admin_maintenance(catalog: CatalogManager, stmt: ast.Admin,
                            ctx: QueryContext) -> Output:
    """Shared ADMIN FLUSH/COMPACT TABLE handler: force the table's
    regions through a flush (memtables → indexed L0 SSTs) or a manual
    compaction. One function for both frontends; the sqlness goldens
    and the index bench use it to pin the on-disk SST layout."""
    catalog_name, schema_name, name = ctx.resolve(stmt.table)
    table = catalog.table(catalog_name, schema_name, name)
    if table is None:
        raise TableNotFoundError(f"table {name!r} not found")
    if stmt.kind == "flush_table":
        table.flush()
        return Output.rows(0)
    regions = getattr(table, "regions", None)
    if not regions:
        # a DistTable over remote datanodes reports an EMPTY region
        # dict, not a missing attribute — silently compacting nothing
        # must not read as success
        raise UnsupportedError(
            "ADMIN COMPACT TABLE needs locally-hosted regions (on a "
            "cluster, run it against the datanodes)")
    for region in regions.values():
        region.compact()
    return Output.rows(0)


#: session variables wire clients set as connection boilerplate (mysql
#: connectors, psql, JDBC). Accepted as no-ops — erroring would break
#: every client handshake — but ONLY these: any other unknown name is a
#: typo'd knob and raises.
_CLIENT_COMPAT_VARS = frozenset({
    "names", "autocommit", "sql_mode", "wait_timeout",
    "net_write_timeout", "net_read_timeout", "interactive_timeout",
    "character_set_results", "character_set_client",
    "character_set_connection", "collation_connection", "sql_select_limit",
    "max_execution_time", "transaction_isolation", "tx_isolation",
    # postgres-dialect session boilerplate
    "client_encoding", "datestyle", "extra_float_digits", "search_path",
    "application_name", "statement_timeout",
})


def apply_set_variable(stmt: ast.SetVariable, ctx: QueryContext) -> Output:
    """Shared SET handler: every knob here is session- or process-level
    state. A knob of a module the port does not have yet raises
    UnsupportedError naming that module."""
    name = stmt.name.lower()
    missing = _KNOBS_NOT_PORTED.get(name)
    if missing is not None:
        raise UnsupportedError(
            f"SET {stmt.name}: {missing} is not ported yet")
    if name in ("time_zone", "timezone"):
        ctx.time_zone = str(stmt.value)
    elif name == "slow_query_threshold_ms":
        # 0 or negative disables; default comes from the
        # GREPTIME_SLOW_QUERY_MS env/config (off when unset)
        from ..common.telemetry import set_slow_query_threshold_ms
        set_slow_query_threshold_ms(_int_setting(stmt))
    elif name == "rollup_rewrite":
        # flow rollup-rewrite kill switch (differential tests and
        # operators compare against the raw path with it off)
        from ..flow import rewrite as flow_rewrite
        try:
            flow_rewrite.set_enabled(bool(int(stmt.value)))
        except (TypeError, ValueError):
            raise InvalidArgumentsError(
                f"SET {stmt.name}: expected 0 or 1, got {stmt.value!r}")
    elif name.startswith("failpoint_"):
        # fault-injection surface: SET failpoint_<point> = 'action'
        # ('off' or 0 disarms). Same registry as GREPTIME_FAILPOINTS
        # (common/failpoint.py).
        from ..common import failpoint
        point = name[len("failpoint_"):]
        spec = str(stmt.value)
        try:
            failpoint.configure(point, None if spec in ("0", "off")
                                else spec)
        except ValueError as e:
            raise InvalidArgumentsError(f"SET {stmt.name}: {e}")
    elif name in ("objstore_max_retries", "objstore_retry_base_ms"):
        from ..storage.retry import configure_retry
        value = _int_setting(stmt)
        if name == "objstore_max_retries":
            configure_retry(max_retries=value)
        else:
            configure_retry(base_ms=value)
    elif name == "stream_threshold_rows":
        # the cold-scan streaming threshold, so operators can pin the
        # dispatch decision without a config reload
        from ..query.stream_exec import configure_streaming
        configure_streaming(threshold_rows=_int_setting(stmt))
    elif name == "approx_error_target":
        # target relative error for the approx aggregates: drives the
        # HLL precision and the t-digest compression together
        from ..query import sketches
        try:
            sketches.configure(error_target=float(stmt.value))
        except (TypeError, ValueError):
            raise InvalidArgumentsError(
                f"SET {stmt.name}: expected a number in [0.001, 0.25], "
                f"got {stmt.value!r}")
    elif name == "scan_fusion":
        # single-flight fusion of concurrent identical scans of one
        # region (query/tpu_exec.py); 0 = every scan solo
        from ..query import tpu_exec
        tpu_exec.configure_scan_fusion(enabled=bool(_int_setting(stmt)))
    elif name == "tpu_dispatch_min_rows":
        # static device-dispatch floor (the latency-adaptive floor never
        # goes below it). Pinning it also resets the adaptive
        # observation: an operator setting the floor expects it to take
        # effect now, not to stay shadowed by the fixed-cost estimate of
        # earlier queries.
        from ..query import tpu_exec
        tpu_exec.TPU_DISPATCH_MIN_ROWS = _int_setting(stmt)
        tpu_exec._observed_min_dt[0] = None
    elif name in ("wal_group_commit", "wal_group_max_wait_us",
                  "wal_group_max_batch"):
        # WAL group-commit knobs: concurrent sync_on_write writers share
        # one fsync; the toggle is the bench differential's kill switch
        from ..storage.wal import configure_group_commit
        value = _int_setting(stmt)
        try:
            if name == "wal_group_commit":
                configure_group_commit(enabled=bool(value))
            elif name == "wal_group_max_wait_us":
                configure_group_commit(max_wait_us=value)
            else:
                configure_group_commit(max_batch=value)
        except ValueError as e:
            raise InvalidArgumentsError(f"SET {stmt.name}: {e}")
    elif name == "sst_index":
        # per-SST secondary indexes (storage/index.py): 0 disables both
        # sidecar writes and every index consult (env twin
        # GREPTIME_SST_INDEX)
        from ..storage.index import configure_sst_index
        configure_sst_index(enabled=bool(_int_setting(stmt)))
    elif name in ("ingest_coalesce", "ingest_coalesce_window_ms"):
        # protocol-ingest coalescer (servers/coalesce.py): merge
        # concurrent small same-table writes into shared bulk batches
        from ..servers.coalesce import configure_coalescer
        value = _int_setting(stmt)
        try:
            if name == "ingest_coalesce":
                configure_coalescer(enabled=bool(value))
            else:
                configure_coalescer(window_ms=value)
        except ValueError as e:
            raise InvalidArgumentsError(f"SET {stmt.name}: {e}")
    elif name in ("admission_max_inflight", "admission_max_queued_bytes",
                  "admission_retry_after_s"):
        # admission gate (common/admission.py): 0 disables a dimension
        from ..common.admission import GATE
        value = _int_setting(stmt)
        try:
            if name == "admission_max_inflight":
                GATE.configure(max_inflight=value)
            elif name == "admission_max_queued_bytes":
                GATE.configure(max_queued_bytes=value)
            else:
                GATE.configure(retry_after_s=value)
        except ValueError as e:
            raise InvalidArgumentsError(f"SET {stmt.name}: {e}")
    elif name.startswith("balancer_"):
        # elastic-region balancer knobs live in meta-srv
        raise InvalidArgumentsError(
            f"SET {stmt.name}: balancer knobs apply to a distributed "
            f"cluster (standalone has no region balancer)")
    elif name in ("read_replica", "replica_max_lag_ms"):
        raise UnsupportedError(
            f"SET {stmt.name}: read replicas require a distributed "
            f"deployment (metasrv + datanodes)")
    elif name in _CLIENT_COMPAT_VARS or name.startswith("@"):
        # connection boilerplate from wire clients: accepted, ignored
        pass
    else:
        # unknown knob: an error, not the silent success that would let
        # a typo'd `SET slow_query_treshold_ms` do nothing
        raise InvalidArgumentsError(
            f"SET {stmt.name}: unknown session variable (see README "
            f"'Session variables' for the supported knobs)")
    return Output.rows(0)


#: the reference's session knobs whose modules the port does not have
#: yet: knob names → what is missing
_KNOBS_NOT_PORTED = {
    **dict.fromkeys(("dist_fanout", "dist_rpc_max_retries",
                     "dist_rpc_retry_base_ms", "dist_partial_agg",
                     "exact_distinct"),
                    "the distributed frontend"),
    **dict.fromkeys(("trace_sample_ratio", "trace_retention_ms"),
                    "the trace store (common/trace_store.py)"),
    **dict.fromkeys(("profiling", "profile_hz", "profile_retention_ms"),
                    "the profiler (common/profiler.py)"),
    **dict.fromkeys(("self_monitor_retention_ms",),
                    "the self-monitor (monitor/)"),
}


class StatementExecutor:
    def __init__(self, catalog: CatalogManager,
                 engines: Dict[str, TableEngine], query_engine,
                 procedure_manager=None, flow_manager=None):
        self.catalog = catalog
        self.engines = engines
        self.query_engine = query_engine
        # when present, DDL runs as durable procedures (reference:
        # table-procedure + mito DDL procedures)
        self.procedure_manager = procedure_manager
        # continuous rollup flows (flow/manager.py)
        self.flow_manager = flow_manager

    def engine_for(self, name: str) -> TableEngine:
        engine = self.engines.get(name)
        if engine is None:
            raise UnsupportedError(f"unknown table engine {name!r}")
        return engine

    # ---- DDL ----
    def create_table(self, stmt: ast.CreateTable, ctx: QueryContext) -> Output:
        catalog, schema_name, table_name = ctx.resolve(stmt.name)
        if not self.catalog.schema_exists(catalog, schema_name):
            raise DatabaseNotFoundError(
                f"schema {catalog}.{schema_name} not found")
        if self.catalog.table(catalog, schema_name, table_name) is not None:
            if stmt.if_not_exists:
                return Output.rows(0)
            from ..errors import TableAlreadyExistsError
            raise TableAlreadyExistsError(
                f"table {table_name!r} already exists")
        schema, pk_indices = build_schema_from_create(stmt)
        # CREATE EXTERNAL TABLE routes to the file engine (reference:
        # file-table-engine; immutable, single-step — no procedure)
        engine_name = "file" if stmt.external else stmt.engine
        engine = self.engine_for(engine_name)
        if stmt.external:
            table = engine.create_table(CreateTableRequest(
                table_name, schema, catalog_name=catalog,
                schema_name=schema_name,
                primary_key_indices=pk_indices,
                create_if_not_exists=stmt.if_not_exists,
                table_options=dict(stmt.options)))
            self.catalog.register_table(catalog, schema_name, table_name,
                                        table)
            return Output.rows(0)
        request = CreateTableRequest(
            table_name, schema, catalog_name=catalog,
            schema_name=schema_name, primary_key_indices=pk_indices,
            create_if_not_exists=stmt.if_not_exists,
            table_options=dict(stmt.options), partitions=stmt.partitions)
        if self.procedure_manager is not None:
            from ..mito.procedure import CreateTableProcedure
            self.procedure_manager.submit(CreateTableProcedure(
                request, engine, self.catalog)).wait()
            return Output.rows(0)
        table = engine.create_table(request)
        self.catalog.register_table(catalog, schema_name, table_name, table)
        return Output.rows(0)

    def create_database(self, stmt: ast.CreateDatabase,
                        ctx: QueryContext) -> Output:
        try:
            self.catalog.register_schema(ctx.current_catalog, stmt.name)
        except DatabaseAlreadyExistsError:
            if not stmt.if_not_exists:
                raise
        return Output.rows(1)

    def drop_table(self, stmt: ast.DropTable, ctx: QueryContext) -> Output:
        catalog, schema_name, table_name = ctx.resolve(stmt.name)
        table = self.catalog.table(catalog, schema_name, table_name)
        if table is None:
            if stmt.if_exists:
                return Output.rows(0)
            raise TableNotFoundError(f"table {table_name!r} not found")
        engine = self.engine_for(table.info.meta.engine)
        request = DropTableRequest(table_name, catalog, schema_name)
        if self.procedure_manager is not None:
            from ..mito.procedure import DropTableProcedure
            self.procedure_manager.submit(DropTableProcedure(
                request, engine, self.catalog)).wait()
            return Output.rows(0)
        engine.drop_table(request)
        self.catalog.deregister_table(catalog, schema_name, table_name)
        return Output.rows(0)

    def drop_database(self, stmt: ast.DropDatabase,
                      ctx: QueryContext) -> Output:
        catalog = ctx.current_catalog
        if not self.catalog.schema_exists(catalog, stmt.name):
            if stmt.if_exists:
                return Output.rows(0)
            raise DatabaseNotFoundError(f"database {stmt.name!r} not found")
        for tname in list(self.catalog.table_names(catalog, stmt.name)):
            table = self.catalog.table(catalog, stmt.name, tname)
            engine = self.engines.get(table.info.meta.engine)
            if engine is not None:
                engine.drop_table(DropTableRequest(tname, catalog, stmt.name))
            self.catalog.deregister_table(catalog, stmt.name, tname)
        self.catalog.deregister_schema(catalog, stmt.name)
        return Output.rows(0)

    def alter_table(self, stmt: ast.AlterTable, ctx: QueryContext) -> Output:
        catalog, schema_name, table_name = ctx.resolve(stmt.table)
        table = self.catalog.table(catalog, schema_name, table_name)
        if table is None:
            raise TableNotFoundError(f"table {table_name!r} not found")
        engine = self.engine_for(table.info.meta.engine)
        op = stmt.operation
        if isinstance(op, ast.AddColumn):
            cs = build_column_schema(op.column, is_tag=False,
                                     is_time_index=False)
            req = AlterTableRequest(
                table_name, AlterKind.ADD_COLUMNS, catalog_name=catalog,
                schema_name=schema_name,
                add_columns=[AddColumnRequest(cs, location=op.location)])
        elif isinstance(op, ast.DropColumn):
            req = AlterTableRequest(
                table_name, AlterKind.DROP_COLUMNS, catalog_name=catalog,
                schema_name=schema_name, drop_columns=[op.name])
        elif isinstance(op, ast.RenameTable):
            req = AlterTableRequest(
                table_name, AlterKind.RENAME_TABLE, catalog_name=catalog,
                schema_name=schema_name, new_table_name=op.new_name)
        else:
            raise UnsupportedError(f"ALTER operation {type(op).__name__}")
        if self.procedure_manager is not None:
            from ..mito.procedure import AlterTableProcedure
            self.procedure_manager.submit(AlterTableProcedure(
                req, engine, self.catalog)).wait()
            return Output.rows(0)
        engine.alter_table(req)
        if isinstance(op, ast.RenameTable):
            self.catalog.rename_table(catalog, schema_name, table_name,
                                      op.new_name)
        return Output.rows(0)

    def truncate_table(self, stmt: ast.TruncateTable,
                       ctx: QueryContext) -> Output:
        catalog, schema_name, table_name = ctx.resolve(stmt.name)
        table = self.catalog.table(catalog, schema_name, table_name)
        if table is None:
            raise TableNotFoundError(f"table {table_name!r} not found")
        engine = self.engine_for(table.info.meta.engine)
        engine.truncate_table(catalog, schema_name, table_name)
        return Output.rows(0)

    # ---- flows (continuous rollups) ----
    def _require_flows(self):
        if self.flow_manager is None:
            raise UnsupportedError("flows are not enabled on this node")
        return self.flow_manager

    def create_flow(self, stmt: ast.CreateFlow, ctx: QueryContext) -> Output:
        self._require_flows().create_flow(stmt, ctx)
        return Output.rows(0)

    def drop_flow(self, stmt: ast.DropFlow, ctx: QueryContext) -> Output:
        self._require_flows().drop_flow(stmt.name, ctx,
                                        if_exists=stmt.if_exists)
        return Output.rows(0)

    def show_flows(self, stmt: ast.ShowFlows, ctx: QueryContext) -> Output:
        return show_flows_output(self._require_flows(), stmt, ctx)

    # ---- COPY ----
    def copy(self, stmt: ast.Copy, ctx: QueryContext) -> Output:
        catalog, schema_name, table_name = ctx.resolve(stmt.table)
        table = self.catalog.table(catalog, schema_name, table_name)
        if table is None:
            raise TableNotFoundError(f"table {table_name!r} not found")
        fmt = str(stmt.options.get("format", "parquet")).lower()
        path = stmt.path
        codec = file_codec(path, stmt.options.get("compression"))
        if stmt.direction == "to":
            return self._copy_to(table, path, fmt, codec)
        return self._copy_from(table, path, fmt, codec)

    def _copy_to(self, table, path: str, fmt: str,
                 codec: Optional[str]) -> Output:
        import pyarrow as pa
        import pyarrow.parquet as pq

        batches = table.scan_batches()
        arrow_batches = [b.to_arrow() for b in batches if b.num_rows]
        tbl = pa.Table.from_batches(arrow_batches) if arrow_batches else \
            pa.Table.from_batches([], schema=table.schema.to_arrow())
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if fmt == "parquet":
            pq.write_table(tbl, path)      # parquet compresses internally
        elif fmt == "csv":
            import pyarrow.csv as pcsv
            with open_compressed_out(path, codec) as sink:
                pcsv.write_csv(tbl, sink)
        elif fmt == "json":
            data = tbl.to_pandas().to_json(None, orient="records",
                                           lines=True, date_format="iso")
            with open_compressed_out(path, codec) as sink:
                sink.write(data.encode())
        else:
            raise UnsupportedError(f"COPY format {fmt!r}")
        return Output.rows(tbl.num_rows)

    def _copy_from(self, table, path: str, fmt: str,
                   codec: Optional[str]) -> Output:
        import io as _io

        import pyarrow as pa
        import pyarrow.parquet as pq

        # csv and json carry no types: each column's is inferred from its
        # text, so a STRING column of digits ('007', a TSBS rack) would
        # arrive as the integer 7 (which bulk ingest of a tag refuses) and
        # an all-null one, from json, as float NaN. The table's STRING
        # columns are read as text; every other column keeps the
        # reference's inference
        strings = {c.name for c in table.schema.column_schemas
                   if c.dtype.is_string}
        if fmt == "parquet":
            tbl = pq.read_table(path)
        elif fmt == "csv":
            import pyarrow.csv as pcsv
            import pyarrow.compute as pc
            with open_compressed_in(path, codec) as src:
                tbl = pcsv.read_csv(src, convert_options=pcsv.ConvertOptions(
                    column_types={c: pa.string() for c in strings}))
            # a column of empty fields only is inferred as nulls, as the
            # reference reads it
            for i, name in enumerate(tbl.column_names):
                if name in strings and tbl.num_rows and \
                        pc.all(pc.equal(tbl[name], "")).as_py():
                    tbl = tbl.set_column(i, name, pa.nulls(tbl.num_rows))
        elif fmt == "json":
            with open_compressed_in(path, codec) as src:
                raw = src.read()
            raw = raw.to_pybytes() if hasattr(raw, "to_pybytes") else raw
            frame = pd.read_json(_io.BytesIO(raw), orient="records",
                                 lines=True,
                                 dtype={c: "object" for c in strings})
            tbl = pa.Table.from_pandas(frame)
        else:
            raise UnsupportedError(f"COPY format {fmt!r}")
        from ..datatypes.record_batch import arrow_to_ingest_columns
        cols = arrow_to_ingest_columns(tbl, table.schema)
        # WAL-less direct-to-SST load when the engine supports it — the
        # SSTs + one manifest edit are the durability story for COPY FROM
        bulk = getattr(table, "bulk_load", None)
        n = bulk(cols) if bulk is not None else table.insert(cols)
        return Output.rows(n)

    # ---- DML ----
    def insert(self, stmt: ast.Insert, ctx: QueryContext) -> Output:
        catalog, schema_name, table_name = ctx.resolve(stmt.table)
        table = self.catalog.table(catalog, schema_name, table_name)
        if table is None:
            raise TableNotFoundError(f"table {table_name!r} not found")
        schema = table.schema
        columns = stmt.columns or schema.names()
        for c in columns:
            if not schema.contains(c):
                from ..errors import ColumnNotFoundError
                raise ColumnNotFoundError(
                    f"column {c!r} not found in {table_name!r}")
        data = evaluate_insert_rows(stmt, columns, self.query_engine, ctx)
        n = table.insert(data)
        return Output.rows(n)

    def delete(self, stmt: ast.Delete, ctx: QueryContext) -> Output:
        catalog, schema_name, table_name = ctx.resolve(stmt.table)
        table = self.catalog.table(catalog, schema_name, table_name)
        if table is None:
            raise TableNotFoundError(f"table {table_name!r} not found")
        return delete_matching_rows(table, stmt)

    # ---- session ----
    def use_database(self, stmt: ast.Use, ctx: QueryContext) -> Output:
        if not self.catalog.schema_exists(ctx.current_catalog, stmt.database):
            raise DatabaseNotFoundError(
                f"database {stmt.database!r} not found")
        ctx.set_current_schema(stmt.database)
        return Output.rows(0)

    def set_variable(self, stmt: ast.SetVariable, ctx: QueryContext) -> Output:
        return apply_set_variable(stmt, ctx)
