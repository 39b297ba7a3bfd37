"""greptime-proto SDK twin: the reference `Database` client's wire flow.

Reference behavior: src/client/src/database.rs — `Database::sql` /
`Database::insert` wrap a GreptimeRequest protobuf in an Arrow Flight
ticket and call do_get; results arrive as a FlightData stream (schema +
record batches, or FlightMetadata{affected_rows} in app_metadata).
This client emits byte-identical tickets, so it doubles as the interop
test harness for any server speaking the greptime-proto plane.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import pyarrow as pa
import pyarrow.flight as flight

from .v1 import (
    Column, ColumnDataType, ColumnDef, CreateTableExpr, DdlRequest,
    GreptimeRequest, InsertRequest, QueryRequest, SemanticType,
    decode_flight_metadata_affected_rows, encode_greptime_request)


def _infer_datatype(values: Sequence) -> int:
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            return ColumnDataType.BOOLEAN
        if isinstance(v, int):
            return ColumnDataType.INT64
        if isinstance(v, float):
            return ColumnDataType.FLOAT64
        if isinstance(v, bytes):
            return ColumnDataType.BINARY
        return ColumnDataType.STRING
    return ColumnDataType.FLOAT64


class GreptimeDatabase:
    """Protobuf-plane client (reference `Database`)."""

    def __init__(self, address: str, *, catalog: str = "greptime",
                 schema: str = "public"):
        self.address = address
        self.conn = flight.FlightClient(address)
        self.catalog = catalog
        self.schema = schema

    def close(self) -> None:
        self.conn.close()

    def _do_get(self, req: GreptimeRequest):
        req.catalog = self.catalog
        req.schema = self.schema
        ticket = flight.Ticket(encode_greptime_request(req))
        return self.conn.do_get(ticket)

    def sql(self, sql: str):
        """Run SQL; returns (pyarrow.Table, affected_rows or None)."""
        reader = self._do_get(GreptimeRequest(query=QueryRequest(sql=sql)))
        batches: List[pa.RecordBatch] = []
        affected: Optional[int] = None
        schema = reader.schema
        while True:
            try:
                chunk = reader.read_chunk()
            except StopIteration:
                break
            if chunk.app_metadata is not None:
                got = decode_flight_metadata_affected_rows(
                    chunk.app_metadata.to_pybytes())
                if got is not None:
                    affected = got
            if chunk.data is not None:
                batches.append(chunk.data)
        table = pa.Table.from_batches(batches, schema=schema) \
            if batches else None
        if (schema.metadata or {}).get(b"gdb.kind") == b"affected_rows":
            if affected is None and table is not None:
                affected = int(table.column(0)[0].as_py())
            table = None
        return table, affected

    def create(self, table_name: str,
               columns: Sequence[Tuple[str, int]], *,
               time_index: str, primary_keys: Sequence[str] = (),
               if_not_exists: bool = True) -> None:
        """DDL over the proto plane (reference Database::create).
        columns: (name, ColumnDataType) pairs."""
        expr = CreateTableExpr(
            table_name=table_name,
            column_defs=[ColumnDef(n, dt, is_nullable=(n != time_index))
                         for n, dt in columns],
            time_index=time_index, primary_keys=list(primary_keys),
            create_if_not_exists=if_not_exists)
        reader = self._do_get(GreptimeRequest(
            ddl=DdlRequest(create_table=expr)))
        reader.read_all()

    def drop_table(self, table_name: str) -> None:
        reader = self._do_get(GreptimeRequest(ddl=DdlRequest(
            drop_table=(self.catalog, self.schema, table_name))))
        reader.read_all()

    def insert(self, table_name: str, columns: Dict[str, Sequence], *,
               tag_columns: Sequence[str] = (),
               timestamp_column: str = "ts",
               datatypes: Optional[Dict[str, int]] = None) -> int:
        """Columnar insert (reference Database::insert). Returns the
        affected-row count reported by the server."""
        row_count = len(next(iter(columns.values()))) if columns else 0
        cols = []
        for name, values in columns.items():
            dt = (datatypes or {}).get(name)
            if dt is None:
                if name == timestamp_column:
                    dt = ColumnDataType.TIMESTAMP_MILLISECOND
                else:
                    dt = _infer_datatype(values)
            sem = SemanticType.FIELD
            if name in tag_columns:
                sem = SemanticType.TAG
            elif name == timestamp_column:
                sem = SemanticType.TIMESTAMP
            cols.append(Column.from_rows(name, values, dt, sem))
        req = GreptimeRequest(insert=InsertRequest(
            table_name=table_name, columns=cols, row_count=row_count))
        reader = self._do_get(req)
        affected = 0
        while True:
            try:
                chunk = reader.read_chunk()
            except StopIteration:
                break
            if chunk.app_metadata is not None:
                got = decode_flight_metadata_affected_rows(
                    chunk.app_metadata.to_pybytes())
                if got is not None:
                    affected = got
        return affected
