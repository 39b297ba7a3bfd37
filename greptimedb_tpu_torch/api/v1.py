"""greptime-proto v1 wire codec (hand-rolled protowire, no protoc).

Field numbers mirror greptime-proto v1 at the revision GreptimeDB
v0.2.0 pins (e8abf824, src/api/Cargo.toml:13):

  GreptimeRequest { RequestHeader header = 1;
                    oneof request { InsertRequest insert = 2;
                                    QueryRequest query = 3;
                                    DdlRequest ddl = 4;
                                    DeleteRequest delete = 5; } }
  RequestHeader   { string catalog = 1; string schema = 2;
                    AuthHeader authorization = 3; string dbname = 4; }
  QueryRequest    { oneof query { string sql = 1; bytes logical_plan = 2;
                                  PromRangeQuery prom_range_query = 3; } }
  InsertRequest   { string table_name = 1; repeated Column columns = 3;
                    uint32 row_count = 4; uint32 region_number = 5; }
  Column          { string column_name = 1; SemanticType semantic_type = 2;
                    Values values = 3; bytes null_mask = 4;
                    ColumnDataType datatype = 5; }
  GreptimeResponse{ ResponseHeader header = 1;
                    oneof response { AffectedRows affected_rows = 2; } }
  FlightMetadata  { AffectedRows affected_rows = 1; }
  AffectedRows    { uint32 value = 1; }

`Column.values` packs only the non-null entries per type-specific
repeated field (Values fields 1-19); `null_mask` is an LSB-first bitmap
over all row_count rows. The deserialized forms here are plain
dataclasses sized to what the servers need: inserts and SQL queries (the
paths reference SDKs use for data); DDL/delete tickets decode to typed
stubs so the server can reject them with a clear error.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.protowire import (
    field_bytes, field_varint, iter_fields, write_varint)


class SemanticType:
    TAG = 0
    FIELD = 1
    TIMESTAMP = 2


class ColumnDataType:
    BOOLEAN = 0
    INT8 = 1
    INT16 = 2
    INT32 = 3
    INT64 = 4
    UINT8 = 5
    UINT16 = 6
    UINT32 = 7
    UINT64 = 8
    FLOAT32 = 9
    FLOAT64 = 10
    BINARY = 11
    STRING = 12
    DATE = 13
    DATETIME = 14
    TIMESTAMP_SECOND = 15
    TIMESTAMP_MILLISECOND = 16
    TIMESTAMP_MICROSECOND = 17
    TIMESTAMP_NANOSECOND = 18


#: Values message: field number per datatype, wire kind.
#: kinds: v = packed varint, f32/f64 = packed fixed, len = length-delim
_VALUES_FIELD: Dict[int, Tuple[int, str]] = {
    ColumnDataType.INT8: (1, "v"),
    ColumnDataType.INT16: (2, "v"),
    ColumnDataType.INT32: (3, "v"),
    ColumnDataType.INT64: (4, "v"),
    ColumnDataType.UINT8: (5, "v"),
    ColumnDataType.UINT16: (6, "v"),
    ColumnDataType.UINT32: (7, "v"),
    ColumnDataType.UINT64: (8, "v"),
    ColumnDataType.FLOAT32: (9, "f32"),
    ColumnDataType.FLOAT64: (10, "f64"),
    ColumnDataType.BOOLEAN: (11, "v"),
    ColumnDataType.BINARY: (12, "len"),
    ColumnDataType.STRING: (13, "len"),
    ColumnDataType.DATE: (14, "v"),
    ColumnDataType.DATETIME: (15, "v"),
    ColumnDataType.TIMESTAMP_SECOND: (16, "v"),
    ColumnDataType.TIMESTAMP_MILLISECOND: (17, "v"),
    ColumnDataType.TIMESTAMP_MICROSECOND: (18, "v"),
    ColumnDataType.TIMESTAMP_NANOSECOND: (19, "v"),
}
_FIELD_TO_DTYPE = {fnum: dt for dt, (fnum, _) in _VALUES_FIELD.items()}

_SIGNED = {ColumnDataType.INT8, ColumnDataType.INT16, ColumnDataType.INT32,
           ColumnDataType.INT64, ColumnDataType.DATE,
           ColumnDataType.DATETIME, ColumnDataType.TIMESTAMP_SECOND,
           ColumnDataType.TIMESTAMP_MILLISECOND,
           ColumnDataType.TIMESTAMP_MICROSECOND,
           ColumnDataType.TIMESTAMP_NANOSECOND}


@dataclass
class Column:
    column_name: str
    semantic_type: int = SemanticType.FIELD
    datatype: int = ColumnDataType.FLOAT64
    values: List = field(default_factory=list)   # non-null entries only
    null_mask: bytes = b""                       # LSB-first, 1 = null

    def rows(self, row_count: int) -> List:
        """Expand to row_count entries with None at masked positions."""
        out: List = []
        it = iter(self.values)
        for i in range(row_count):
            if self.null_mask and (i // 8) < len(self.null_mask) and \
                    (self.null_mask[i // 8] >> (i % 8)) & 1:
                out.append(None)
            else:
                out.append(next(it, None))
        return out

    @staticmethod
    def from_rows(name: str, rows: Sequence, datatype: int,
                  semantic_type: int = SemanticType.FIELD) -> "Column":
        mask = bytearray((len(rows) + 7) // 8)
        vals = []
        any_null = False
        for i, v in enumerate(rows):
            if v is None:
                mask[i // 8] |= 1 << (i % 8)
                any_null = True
            else:
                vals.append(v)
        return Column(name, semantic_type, datatype, vals,
                      bytes(mask) if any_null else b"")


@dataclass
class InsertRequest:
    table_name: str
    columns: List[Column] = field(default_factory=list)
    row_count: int = 0
    region_number: int = 0


@dataclass
class QueryRequest:
    sql: Optional[str] = None


@dataclass
class ColumnDef:
    """greptime-proto ColumnDef { string name = 1;
    ColumnDataType datatype = 2; bool is_nullable = 3;
    bytes default_constraint = 4; }"""
    name: str
    datatype: int
    is_nullable: bool = True


@dataclass
class CreateTableExpr:
    """CreateTableExpr { catalog_name = 1; schema_name = 2;
    table_name = 3; desc = 4; repeated ColumnDef column_defs = 5;
    string time_index = 6; repeated string primary_keys = 7;
    bool create_if_not_exists = 8; map table_options = 9;
    TableId table_id = 10; repeated uint32 region_ids = 11;
    string engine = 12; }"""
    table_name: str
    column_defs: List[ColumnDef] = field(default_factory=list)
    time_index: str = ""
    primary_keys: List[str] = field(default_factory=list)
    create_if_not_exists: bool = False
    catalog_name: str = ""
    schema_name: str = ""


@dataclass
class DdlRequest:
    """DdlRequest oneof: create_database = 1; create_table = 2;
    alter = 3; drop_table = 4; flush_table = 5."""
    create_table: Optional[CreateTableExpr] = None
    drop_table: Optional[Tuple[str, str, str]] = None   # catalog,schema,table
    create_database: Optional[str] = None
    other: Optional[str] = None


@dataclass
class GreptimeRequest:
    catalog: str = ""
    schema: str = ""
    dbname: str = ""
    insert: Optional[InsertRequest] = None
    query: Optional[QueryRequest] = None
    ddl: Optional[DdlRequest] = None
    other: Optional[str] = None      # "delete" (decoded as a stub)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _encode_values(datatype: int, values: Sequence) -> bytes:
    fnum, kind = _VALUES_FIELD[datatype]
    if kind == "len":
        out = b"".join(
            field_bytes(fnum, v.encode() if isinstance(v, str) else bytes(v))
            for v in values)
        return out
    if kind in ("f32", "f64"):
        fmt = "<f" if kind == "f32" else "<d"
        packed = b"".join(struct.pack(fmt, float(v)) for v in values)
        return field_bytes(fnum, packed) if values else b""
    # packed varints (proto3 default for repeated scalars)
    buf = bytearray()
    for v in values:
        if datatype == ColumnDataType.BOOLEAN:
            buf += write_varint(1 if v else 0)
        elif datatype in _SIGNED:
            # proto int64/int32: negative values ride as 10-byte varints
            buf += write_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
        else:
            buf += write_varint(int(v))
    return field_bytes(fnum, bytes(buf)) if values else b""


def encode_column(c: Column) -> bytes:
    out = field_bytes(1, c.column_name.encode())
    if c.semantic_type:
        out += field_varint(2, c.semantic_type)
    vals = _encode_values(c.datatype, c.values)
    if vals:
        out += field_bytes(3, vals)
    if c.null_mask:
        out += field_bytes(4, c.null_mask)
    if c.datatype:
        out += field_varint(5, c.datatype)
    return out


def encode_insert(req: InsertRequest) -> bytes:
    out = field_bytes(1, req.table_name.encode())
    for c in req.columns:
        out += field_bytes(3, encode_column(c))
    out += field_varint(4, req.row_count)
    if req.region_number:
        out += field_varint(5, req.region_number)
    return out


def encode_column_def(cd: ColumnDef) -> bytes:
    out = field_bytes(1, cd.name.encode())
    if cd.datatype:
        out += field_varint(2, cd.datatype)
    if cd.is_nullable:
        out += field_varint(3, 1)
    return out


def encode_create_table(ct: CreateTableExpr) -> bytes:
    out = b""
    if ct.catalog_name:
        out += field_bytes(1, ct.catalog_name.encode())
    if ct.schema_name:
        out += field_bytes(2, ct.schema_name.encode())
    out += field_bytes(3, ct.table_name.encode())
    for cd in ct.column_defs:
        out += field_bytes(5, encode_column_def(cd))
    if ct.time_index:
        out += field_bytes(6, ct.time_index.encode())
    for pk in ct.primary_keys:
        out += field_bytes(7, pk.encode())
    if ct.create_if_not_exists:
        out += field_varint(8, 1)
    return out


def encode_ddl(ddl: DdlRequest) -> bytes:
    if ddl.create_table is not None:
        return field_bytes(2, encode_create_table(ddl.create_table))
    if ddl.drop_table is not None:
        cat, sch, tbl = ddl.drop_table
        body = b""
        if cat:
            body += field_bytes(1, cat.encode())
        if sch:
            body += field_bytes(2, sch.encode())
        body += field_bytes(3, tbl.encode())
        return field_bytes(4, body)
    if ddl.create_database is not None:
        return field_bytes(1, field_bytes(1, ddl.create_database.encode()))
    raise ValueError("empty DdlRequest")


def encode_greptime_request(req: GreptimeRequest) -> bytes:
    header = b""
    if req.catalog:
        header += field_bytes(1, req.catalog.encode())
    if req.schema:
        header += field_bytes(2, req.schema.encode())
    if req.dbname:
        header += field_bytes(4, req.dbname.encode())
    out = field_bytes(1, header) if header else b""
    if req.insert is not None:
        out += field_bytes(2, encode_insert(req.insert))
    elif req.query is not None and req.query.sql is not None:
        out += field_bytes(3, field_bytes(1, req.query.sql.encode()))
    elif req.ddl is not None:
        out += field_bytes(4, encode_ddl(req.ddl))
    return out


def encode_affected_rows_metadata(n: int) -> bytes:
    """FlightMetadata { AffectedRows affected_rows = 1; } — rides in
    FlightData.app_metadata (reference flight.rs:84-90)."""
    return field_bytes(1, field_varint(1, n))


def encode_greptime_response(n: int) -> bytes:
    """GreptimeResponse with affected_rows (the handle() RPC reply)."""
    header = field_bytes(1, field_varint(1, 0))   # status_code OK
    return field_bytes(1, header) + field_bytes(2, field_varint(1, n))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _u64_to_i64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _decode_values(data: bytes) -> Dict[int, List]:
    """Values message → {datatype: [non-null entries]}."""
    out: Dict[int, List] = {}
    for fnum, wire, payload in iter_fields(memoryview(data)):
        dt = _FIELD_TO_DTYPE.get(fnum)
        if dt is None:
            continue
        _, kind = _VALUES_FIELD[dt]
        dest = out.setdefault(dt, [])
        if kind == "len":
            raw = bytes(payload)
            dest.append(raw.decode() if dt == ColumnDataType.STRING
                        else raw)
        elif kind in ("f32", "f64"):
            fmt, width = ("<f", 4) if kind == "f32" else ("<d", 8)
            if wire == 5 or wire == 1:     # non-packed single value
                dest.append(struct.unpack(fmt, bytes(payload))[0])
            else:                          # packed
                raw = bytes(payload)
                dest.extend(struct.unpack(fmt, raw[i:i + width])[0]
                            for i in range(0, len(raw), width))
        else:
            if wire == 0:                  # non-packed varint
                vals = [payload]
            else:                          # packed varints
                vals = _iter_varints(bytes(payload))
            for v in vals:
                if dt == ColumnDataType.BOOLEAN:
                    dest.append(bool(v))
                elif dt in _SIGNED:
                    dest.append(_u64_to_i64(v))
                else:
                    dest.append(v)
    return out


def _iter_varints(data: bytes) -> List[int]:
    from ..utils.protowire import read_varint
    out, pos, mv = [], 0, memoryview(data)
    while pos < len(data):
        v, pos = read_varint(mv, pos)
        out.append(v)
    return out


def decode_column(data: bytes) -> Column:
    name, sem, dtype, mask = "", 0, ColumnDataType.FLOAT64, b""
    values_raw = b""
    for fnum, wire, payload in iter_fields(memoryview(data)):
        if fnum == 1:
            name = bytes(payload).decode()
        elif fnum == 2:
            sem = payload
        elif fnum == 3:
            values_raw = bytes(payload)
        elif fnum == 4:
            mask = bytes(payload)
        elif fnum == 5:
            dtype = payload
    vals_by_type = _decode_values(values_raw) if values_raw else {}
    values = vals_by_type.get(dtype)
    if values is None and vals_by_type:
        # tolerate a datatype/values-field mismatch: take what was sent
        dtype, values = next(iter(vals_by_type.items()))
    return Column(name, sem, dtype, values or [], mask)


def decode_insert(data: bytes) -> InsertRequest:
    req = InsertRequest(table_name="")
    for fnum, wire, payload in iter_fields(memoryview(data)):
        if fnum == 1:
            req.table_name = bytes(payload).decode()
        elif fnum == 3:
            req.columns.append(decode_column(bytes(payload)))
        elif fnum == 4:
            req.row_count = payload
        elif fnum == 5:
            req.region_number = payload
    return req


def decode_column_def(data: bytes) -> ColumnDef:
    cd = ColumnDef(name="", datatype=ColumnDataType.FLOAT64,
                   is_nullable=False)
    for fnum, _, payload in iter_fields(memoryview(data)):
        if fnum == 1:
            cd.name = bytes(payload).decode()
        elif fnum == 2:
            cd.datatype = payload
        elif fnum == 3:
            cd.is_nullable = bool(payload)
    return cd


def decode_create_table(data: bytes) -> CreateTableExpr:
    ct = CreateTableExpr(table_name="")
    for fnum, _, payload in iter_fields(memoryview(data)):
        if fnum == 1:
            ct.catalog_name = bytes(payload).decode()
        elif fnum == 2:
            ct.schema_name = bytes(payload).decode()
        elif fnum == 3:
            ct.table_name = bytes(payload).decode()
        elif fnum == 5:
            ct.column_defs.append(decode_column_def(bytes(payload)))
        elif fnum == 6:
            ct.time_index = bytes(payload).decode()
        elif fnum == 7:
            ct.primary_keys.append(bytes(payload).decode())
        elif fnum == 8:
            ct.create_if_not_exists = bool(payload)
    return ct


def decode_ddl(data: bytes) -> DdlRequest:
    ddl = DdlRequest()
    for fnum, _, payload in iter_fields(memoryview(data)):
        if fnum == 1:
            for df, _, dp in iter_fields(memoryview(bytes(payload))):
                if df == 1:
                    ddl.create_database = bytes(dp).decode()
        elif fnum == 2:
            ddl.create_table = decode_create_table(bytes(payload))
        elif fnum == 4:
            cat = sch = tbl = ""
            for df, _, dp in iter_fields(memoryview(bytes(payload))):
                if df == 1:
                    cat = bytes(dp).decode()
                elif df == 2:
                    sch = bytes(dp).decode()
                elif df == 3:
                    tbl = bytes(dp).decode()
            ddl.drop_table = (cat, sch, tbl)
        elif fnum == 3:
            ddl.other = "alter"
        elif fnum == 5:
            ddl.other = "flush_table"
    return ddl


def decode_greptime_request(data: bytes) -> GreptimeRequest:
    req = GreptimeRequest()
    for fnum, wire, payload in iter_fields(memoryview(data)):
        if fnum == 1:
            for hf, _, hp in iter_fields(memoryview(bytes(payload))):
                if hf == 1:
                    req.catalog = bytes(hp).decode()
                elif hf == 2:
                    req.schema = bytes(hp).decode()
                elif hf == 4:
                    req.dbname = bytes(hp).decode()
        elif fnum == 2:
            req.insert = decode_insert(bytes(payload))
        elif fnum == 3:
            for qf, _, qp in iter_fields(memoryview(bytes(payload))):
                if qf == 1:
                    req.query = QueryRequest(sql=bytes(qp).decode())
        elif fnum == 4:
            req.ddl = decode_ddl(bytes(payload))
        elif fnum == 5:
            req.other = "delete"
    return req


#: ColumnDataType → SQL type name (the DDL translation the server runs)
SQL_TYPE_NAMES = {
    ColumnDataType.BOOLEAN: "BOOLEAN",
    ColumnDataType.INT8: "TINYINT",
    ColumnDataType.INT16: "SMALLINT",
    ColumnDataType.INT32: "INT",
    ColumnDataType.INT64: "BIGINT",
    ColumnDataType.UINT8: "TINYINT UNSIGNED",
    ColumnDataType.UINT16: "SMALLINT UNSIGNED",
    ColumnDataType.UINT32: "INT UNSIGNED",
    ColumnDataType.UINT64: "BIGINT UNSIGNED",
    ColumnDataType.FLOAT32: "FLOAT",
    ColumnDataType.FLOAT64: "DOUBLE",
    ColumnDataType.BINARY: "BLOB",
    ColumnDataType.STRING: "STRING",
    ColumnDataType.DATE: "DATE",
    ColumnDataType.DATETIME: "DATETIME",
    ColumnDataType.TIMESTAMP_SECOND: "TIMESTAMP(0)",
    ColumnDataType.TIMESTAMP_MILLISECOND: "TIMESTAMP(3)",
    ColumnDataType.TIMESTAMP_MICROSECOND: "TIMESTAMP(6)",
    ColumnDataType.TIMESTAMP_NANOSECOND: "TIMESTAMP(9)",
}


def create_table_to_sql(ct: CreateTableExpr) -> str:
    """CreateTableExpr → CREATE TABLE statement (the server-side DDL
    translation; reference grpc handlers build table requests directly,
    src/common/grpc-expr/src/)."""
    cols = []
    for cd in ct.column_defs:
        ty = SQL_TYPE_NAMES.get(cd.datatype, "DOUBLE")
        null = "" if cd.is_nullable or cd.name == ct.time_index \
            else " NOT NULL"
        entry = f'"{cd.name}" {ty}{null}'
        if cd.name == ct.time_index:
            entry += " TIME INDEX"
        cols.append(entry)
    if ct.primary_keys:
        keys = ", ".join(f'"{k}"' for k in ct.primary_keys)
        cols.append(f"PRIMARY KEY({keys})")
    ine = "IF NOT EXISTS " if ct.create_if_not_exists else ""
    return f'CREATE TABLE {ine}"{ct.table_name}" ({", ".join(cols)})'


def decode_flight_metadata_affected_rows(data: bytes) -> Optional[int]:
    for fnum, _, payload in iter_fields(memoryview(data)):
        if fnum == 1:
            for af, _, ap in iter_fields(memoryview(bytes(payload))):
                if af == 1:
                    return int(ap)
            return 0
    return None
