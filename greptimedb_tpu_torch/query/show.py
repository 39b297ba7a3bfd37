"""SHOW / DESCRIBE statement implementations.

Reference behavior: src/query/src/sql.rs:441 + sql/show.rs:337 — SHOW
DATABASES/TABLES with LIKE/WHERE, SHOW CREATE TABLE, DESCRIBE with the
Column/Type/Null/Key/Default/Semantic Type layout.

Ported from greptimedb_tpu/query/show.py (less the distributed table's
route refresh before SHOW CREATE TABLE: the port has no distributed
tables yet).
"""

from __future__ import annotations

import re
from typing import List

import pandas as pd

from ..datatypes import data_type as dt
from ..datatypes.record_batch import RecordBatch
from ..datatypes.schema import ColumnSchema, Schema
from ..errors import TableNotFoundError
from ..session import QueryContext
from .expr import Evaluator, like_to_regex
from .output import Output

_SQL_TYPE_NAMES = {
    "Boolean": "Boolean", "Int8": "Int8", "Int16": "Int16", "Int32": "Int32",
    "Int64": "Int64", "UInt8": "UInt8", "UInt16": "UInt16",
    "UInt32": "UInt32", "UInt64": "UInt64", "Float32": "Float32",
    "Float64": "Float64", "String": "String", "Binary": "Binary",
    "Date": "Date", "TimestampSecond": "TimestampSecond",
    "TimestampMillisecond": "TimestampMillisecond",
    "TimestampMicrosecond": "TimestampMicrosecond",
    "TimestampNanosecond": "TimestampNanosecond",
}


def _one_col(name: str, values: List[str]) -> Output:
    schema = Schema([ColumnSchema(name, dt.STRING)])
    return Output.record_batches(
        [RecordBatch.from_pydict(schema, {name: values})], schema)


def _filter_names(names: List[str], like, where, col_name: str) -> List[str]:
    if like:
        rx = re.compile(like_to_regex(like))
        names = [n for n in names if rx.match(n)]
    if where is not None:
        df = pd.DataFrame({col_name: names})
        mask = Evaluator(df).eval(where)
        if isinstance(mask, pd.Series):
            names = [n for n, ok in zip(names, mask.fillna(False)) if ok]
        elif not mask:
            names = []
    return names


def show_databases(engine, stmt, ctx: QueryContext) -> Output:
    names = engine.catalog.schema_names(ctx.current_catalog)
    names = _filter_names(names, stmt.like, stmt.where, "Database")
    return _one_col("Databases", names)


def show_tables(engine, stmt, ctx: QueryContext) -> Output:
    schema_name = stmt.database or ctx.current_schema
    names = engine.catalog.table_names(ctx.current_catalog, schema_name)
    names = _filter_names(names, stmt.like, stmt.where, "Table")
    return _one_col("Tables", names)


def describe_table(engine, stmt, ctx: QueryContext) -> Output:
    table = engine.resolve_table(stmt.table, ctx)
    pks = set(table.info.meta.primary_key_names)
    cols, types, nulls, defaults, keys, semantics = [], [], [], [], [], []
    for cs in table.schema.column_schemas:
        cols.append(cs.name)
        types.append(_SQL_TYPE_NAMES.get(cs.dtype.name, cs.dtype.name))
        nulls.append("YES" if cs.nullable else "NO")
        if cs.default is None:
            defaults.append("")
        elif cs.default.function:
            defaults.append(f"{cs.default.function}()")
        else:
            defaults.append(str(cs.default.value))
        if cs.is_time_index:
            keys.append("TIME INDEX")
            semantics.append("TIMESTAMP")
        elif cs.name in pks or cs.is_tag:
            keys.append("PRI")
            semantics.append("TAG")
        else:
            keys.append("")
            semantics.append("FIELD")
    schema = Schema([ColumnSchema(n, dt.STRING) for n in
                     ("Column", "Type", "Null", "Key", "Default",
                      "Semantic Type")])
    rb = RecordBatch.from_pydict(schema, {
        "Column": cols, "Type": types, "Null": nulls, "Key": keys,
        "Default": defaults, "Semantic Type": semantics})
    return Output.record_batches([rb], schema)


def show_create_table(engine, stmt, ctx: QueryContext) -> Output:
    table = engine.resolve_table(stmt.table, ctx)
    info = table.info
    lines = [f"CREATE TABLE IF NOT EXISTS {info.name} ("]
    defs = []
    for cs in table.schema.column_schemas:
        d = f"  {cs.name} {_SQL_TYPE_NAMES.get(cs.dtype.name, cs.dtype.name)}"
        if not cs.nullable:
            d += " NOT NULL"
        if cs.default is not None:
            if cs.default.function:
                d += f" DEFAULT {cs.default.function}()"
            else:
                d += f" DEFAULT {cs.default.value!r}"
        defs.append(d)
    tc = table.schema.timestamp_column
    if tc is not None:
        defs.append(f"  TIME INDEX ({tc.name})")
    pks = info.meta.primary_key_names
    if pks:
        defs.append(f"  PRIMARY KEY ({', '.join(pks)})")
    lines.append(",\n".join(defs))
    lines.append(")")
    rule = getattr(table, "partition_rule", None)
    from ..partition.rule import HashPartitionRule
    if isinstance(rule, HashPartitionRule):
        cols = ", ".join(rule.partition_columns())
        lines.append(f"PARTITION BY HASH ({cols}) "
                     f"PARTITIONS {len(rule.regions)}")
    elif rule is not None and getattr(rule, "bounds", None):
        # render the partition clause (reference SHOW CREATE TABLE
        # includes it, src/sql/src/statements/create.rs)
        cols = ", ".join(rule.partition_columns())

        def bound_text(b):
            vals = b if isinstance(b, tuple) else (b,)
            parts = []
            for v in vals:
                if v is None or (isinstance(v, str) and
                                 v.upper() == "MAXVALUE"):
                    parts.append("MAXVALUE")
                elif isinstance(v, str):
                    parts.append("'" + v.replace("'", "''") + "'")
                else:
                    parts.append(str(v))
            return ", ".join(parts)
        entries = ",\n".join(
            f"  PARTITION p{i} VALUES LESS THAN ({bound_text(b)})"
            for i, b in enumerate(rule.bounds))
        lines.append(f"PARTITION BY RANGE COLUMNS ({cols}) (\n{entries}\n)")
    lines.append(f"ENGINE={info.meta.engine}")
    if info.meta.options:
        opts = ", ".join(f"{k}={v!r}" for k, v in info.meta.options.items())
        lines.append(f"WITH({opts})")
    ddl = "\n".join(lines)
    schema = Schema([ColumnSchema("Table", dt.STRING),
                     ColumnSchema("Create Table", dt.STRING)])
    rb = RecordBatch.from_pydict(schema, {"Table": [info.name],
                                          "Create Table": [ddl]})
    return Output.record_batches([rb], schema)


def show_processlist(engine, stmt, ctx: QueryContext) -> Output:
    """SHOW [FULL] PROCESSLIST over the process-wide active-statement
    registry (common/process_list.py) — the same rows
    information_schema.processes serves. Non-FULL truncates the
    statement text at 100 chars, the MySQL `Info` convention."""
    from ..common import process_list
    rows = process_list.REGISTRY.rows()
    schema = Schema([
        ColumnSchema("Id", dt.INT64),
        ColumnSchema("Node", dt.STRING),
        ColumnSchema("Db", dt.STRING),
        ColumnSchema("Protocol", dt.STRING),
        ColumnSchema("State", dt.STRING),
        ColumnSchema("Elapsed_ms", dt.INT64),
        ColumnSchema("Rows_scanned", dt.INT64),
        ColumnSchema("Bytes_read", dt.INT64),
        ColumnSchema("Trace_id", dt.STRING),
        ColumnSchema("Info", dt.STRING),
    ])
    full = bool(getattr(stmt, "full", False))
    rb = RecordBatch.from_pydict(schema, {
        "Id": [r["id"] for r in rows],
        "Node": [r["node"] for r in rows],
        "Db": [r["schema"] for r in rows],
        "Protocol": [r["protocol"] for r in rows],
        "State": [r["state"] for r in rows],
        "Elapsed_ms": [int(r["elapsed_ms"]) for r in rows],
        "Rows_scanned": [r["rows_scanned"] for r in rows],
        "Bytes_read": [r["bytes_read"] for r in rows],
        "Trace_id": [r["trace_id"] for r in rows],
        "Info": [r["query"] if full else r["query"][:100]
                 for r in rows],
    })
    return Output.record_batches([rb], schema)


def show_variable(engine, stmt, ctx: QueryContext) -> Output:
    """MySQL-compat surface: SHOW VARIABLES / FULL TABLES etc. return an
    empty-ish answer rather than erroring (reference: mysql federated)."""
    name = (stmt.name or "").strip().lower()
    if name.startswith("variables"):
        schema = Schema([ColumnSchema("Variable_name", dt.STRING),
                         ColumnSchema("Value", dt.STRING)])
        rb = RecordBatch.from_pydict(
            schema, {"Variable_name": ["system_time_zone"],
                     "Value": [ctx.time_zone]})
        return Output.record_batches([rb], schema)
    return _one_col("Value", [])
