"""Differential tests of the port's greptime-proto codec and its interop.

greptimedb_tpu_torch/api/ against greptimedb_tpu/api/: the same requests
(inserts of every column type with null masks, queries, DDL, ten-byte
negative varints, the affected-rows metadata) encode to the same bytes
and decode to the same requests. Then both packages' clients (the
proto-plane `GreptimeDatabase` and the JSON-plane `Database`) run one
script of steps against both packages' Flight servers: each client
against the other package's server gets what each package's client gets
from its own (SQL, proto inserts with auto-create, DDL, the schema of a
request header, DDL refusals, errors rebuilt as the same types).
"""

import json
import tempfile
import time
import types

import pyarrow.flight as flight
import pytest

from greptimedb_tpu.api import v1 as ref_v1
from greptimedb_tpu_torch.api import v1 as port_v1

V1 = {"reference": ref_v1, "port": port_v1}


def _insert(v1):
    dt = v1.ColumnDataType
    cols = [
        v1.Column.from_rows("host", ["a", "b", None, "é"], dt.STRING,
                            v1.SemanticType.TAG),
        v1.Column.from_rows("ts", [1000, 2000, 3000, -4000],
                            dt.TIMESTAMP_MILLISECOND,
                            v1.SemanticType.TIMESTAMP),
        v1.Column.from_rows("f64", [1.5, None, -2.5, 1e300], dt.FLOAT64),
        v1.Column.from_rows("f32", [0.25, 2.0, None, -1.0], dt.FLOAT32),
        v1.Column.from_rows("i64", [-1, 2, None, -(2 ** 63)], dt.INT64),
        v1.Column.from_rows("i32", [None, -7, 2 ** 31 - 1, 0], dt.INT32),
        v1.Column.from_rows("i8", [-128, 127, None, 0], dt.INT8),
        v1.Column.from_rows("u64", [2 ** 64 - 1, 0, None, 5], dt.UINT64),
        v1.Column.from_rows("u8", [255, None, 0, 1], dt.UINT8),
        v1.Column.from_rows("ok", [True, False, None, True], dt.BOOLEAN),
        v1.Column.from_rows("bin", [b"\x00\xff", None, b"", b"x"],
                            dt.BINARY),
        v1.Column.from_rows("d", [1, -1, None, 19000], dt.DATE),
        v1.Column.from_rows("ns", [None, None, None, None],
                            dt.TIMESTAMP_NANOSECOND),
    ]
    return v1.GreptimeRequest(catalog="greptime", schema="public",
                              insert=v1.InsertRequest("metrics", cols,
                                                      row_count=4))


def _wide_nulls(v1):
    rows = [None if i % 3 == 0 else float(i) for i in range(19)]
    return v1.GreptimeRequest(dbname="greptime-other", insert=v1.InsertRequest(
        "wide", [v1.Column.from_rows("v", rows, v1.ColumnDataType.FLOAT64)],
        row_count=19, region_number=3))


def _create(v1):
    dt = v1.ColumnDataType
    return v1.GreptimeRequest(ddl=v1.DdlRequest(
        create_table=v1.CreateTableExpr(
            table_name="t", time_index="ts", primary_keys=["h", "g"],
            create_if_not_exists=True, catalog_name="greptime",
            schema_name="public", column_defs=[
                v1.ColumnDef("h", dt.STRING, True),
                v1.ColumnDef("g", dt.INT32, True),
                v1.ColumnDef("ts", dt.TIMESTAMP_MILLISECOND, False),
                v1.ColumnDef("v", dt.FLOAT64, True)])))


REQUESTS = {
    "insert": _insert,
    "insert_wide_null_mask": _wide_nulls,
    "query": lambda v1: v1.GreptimeRequest(
        dbname="d", query=v1.QueryRequest(sql="SELECT 1")),
    "query_header": lambda v1: v1.GreptimeRequest(
        catalog="c", schema="s", query=v1.QueryRequest(
            sql="SELECT host FROM \"t\" WHERE v < -1")),
    "create_table": _create,
    "drop_table": lambda v1: v1.GreptimeRequest(ddl=v1.DdlRequest(
        drop_table=("greptime", "public", "t"))),
    "create_database": lambda v1: v1.GreptimeRequest(ddl=v1.DdlRequest(
        create_database="db1")),
    "negative_varint": lambda v1: v1.GreptimeRequest(
        insert=v1.InsertRequest("n", [v1.Column.from_rows(
            "n", [-5, -1, -(2 ** 40)], v1.ColumnDataType.INT64)],
            row_count=3)),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_encodings_are_byte_equal(name):
    """Each request encodes to the same bytes in both packages, and each
    package decodes those bytes to the same request."""
    enc = {side: v1.encode_greptime_request(REQUESTS[name](v1))
           for side, v1 in V1.items()}
    assert enc["port"] == enc["reference"]
    dec = {side: repr(v1.decode_greptime_request(enc["reference"]))
           for side, v1 in V1.items()}
    assert dec["port"] == dec["reference"].replace(
        "greptimedb_tpu.", "greptimedb_tpu_torch.")


def test_negative_ints_use_ten_byte_varints():
    """proto3 int64 negatives are 10-byte two's-complement varints."""
    for v1 in V1.values():
        c = v1.Column.from_rows("n", [-5], v1.ColumnDataType.INT64)
        data = v1.encode_column(c)
        assert v1.decode_column(data).rows(1) == [-5]
    assert port_v1.encode_column(port_v1.Column.from_rows(
        "n", [-5], port_v1.ColumnDataType.INT64)) == ref_v1.encode_column(
        ref_v1.Column.from_rows("n", [-5], ref_v1.ColumnDataType.INT64))


@pytest.mark.parametrize("n", [0, 1, 127, 128, 2 ** 32 - 1])
def test_affected_rows_metadata(n):
    """FlightMetadata{affected_rows} and GreptimeResponse bytes."""
    for enc in ("encode_affected_rows_metadata", "encode_greptime_response"):
        assert getattr(port_v1, enc)(n) == getattr(ref_v1, enc)(n)
    data = ref_v1.encode_affected_rows_metadata(n)
    assert port_v1.decode_flight_metadata_affected_rows(data) == \
        ref_v1.decode_flight_metadata_affected_rows(data) == n


def test_unknown_variants_and_create_sql():
    """Delete and alter decode to named stubs; a CreateTableExpr renders
    the same SQL."""
    from greptimedb_tpu.utils.protowire import field_bytes
    for v1 in V1.values():
        assert v1.decode_greptime_request(field_bytes(5, b"")).other == \
            "delete"
        alter = field_bytes(4, field_bytes(3, b""))
        assert v1.decode_greptime_request(alter).ddl.other == "alter"
    sql = {side: v1.create_table_to_sql(_create(v1).ddl.create_table)
           for side, v1 in V1.items()}
    assert sql["port"] == sql["reference"]


# ---------------------------------------------------------------------------
# interop: each package's clients against each package's Flight server
# ---------------------------------------------------------------------------

def serve(pkg, home):
    """A standalone frontend of `pkg` behind its FlightFrontendServer."""
    if pkg == "reference":
        from greptimedb_tpu.datanode.instance import (
            DatanodeInstance, DatanodeOptions)
        from greptimedb_tpu.frontend.instance import FrontendInstance
        from greptimedb_tpu.servers.flight import FlightFrontendServer
        opts = DatanodeOptions(data_home=home, register_numbers_table=False)
    else:
        from greptimedb_tpu_torch.datanode import (
            DatanodeInstance, DatanodeOptions)
        from greptimedb_tpu_torch.frontend import FrontendInstance
        from greptimedb_tpu_torch.servers.flight import FlightFrontendServer
        opts = DatanodeOptions(data_home=home, register_numbers_table=False,
                               device="cpu")
    fe = FrontendInstance(DatanodeInstance(opts))
    fe.start()
    srv = FlightFrontendServer(fe)
    srv.serve_in_background()
    t0 = time.time()
    while srv.port == 0 and time.time() - t0 < 10:
        time.sleep(0.01)
    return fe, srv


def clients(pkg, address):
    if pkg == "reference":
        from greptimedb_tpu.api.client import GreptimeDatabase
        from greptimedb_tpu.client.flight import Database
        v1 = ref_v1
    else:
        from greptimedb_tpu_torch.api.client import GreptimeDatabase
        from greptimedb_tpu_torch.client.flight import Database
        v1 = port_v1
    return types.SimpleNamespace(
        proto=GreptimeDatabase(address), db=Database(address), v1=v1,
        other=GreptimeDatabase(address, schema="protodb"),
        GreptimeDatabase=GreptimeDatabase)


def _error(e):
    msg = str(e).split(". gRPC client debug context:")[0]
    # the server's traceback (its package's file names) follows "Detail:"
    msg = msg.split(". Detail: Python exception:")[0]
    return ("error", type(e).__name__, msg)


def _table(res):
    table, affected = res
    if table is None:
        return (None, affected)
    return ([str(f) for f in table.schema], table.to_pydict(), affected)


def _batches(out):
    if isinstance(out, int):
        return out
    return [([str(f) for f in b.to_arrow().schema],
             b.to_arrow().to_pydict()) for b in out]


def _raw(c, ticket):
    return c.proto.conn.do_get(flight.Ticket(ticket)).read_all().to_pydict()


STEPS = [
    ("proto insert auto-create", lambda c: c.proto.insert(
        "proto_metrics", {"host": ["h0", "h1", "h0"], "ts": [1000, 2000,
                                                              3000],
                          "cpu": [0.5, None, 0.7], "n": [1, 2, None]},
        tag_columns=["host"], timestamp_column="ts")),
    ("proto sql select", lambda c: _table(c.proto.sql(
        "SELECT host, cpu, n FROM proto_metrics ORDER BY ts"))),
    ("proto sql affected rows", lambda c: _table(c.proto.sql(
        "INSERT INTO proto_metrics VALUES ('h2', 4000, 1.0, 3)"))),
    ("proto insert into existing", lambda c: c.proto.insert(
        "proto_metrics", {"host": ["h3"], "ts": [5000], "cpu": [2.5],
                          "n": [None]},
        tag_columns=["host"], timestamp_column="ts")),
    ("json ticket on the proto client", lambda c: _raw(c, json.dumps(
        {"type": "sql", "sql": "SELECT count(*) FROM proto_metrics"}
    ).encode())),
    ("proto aggregate", lambda c: _table(c.proto.sql(
        "SELECT host, count(*), sum(cpu), max(n) FROM proto_metrics GROUP "
        "BY host ORDER BY host"))),
    ("proto ddl create", lambda c: c.proto.create(
        "proto_ddl_t", [("host", c.v1.ColumnDataType.STRING),
                        ("ts", c.v1.ColumnDataType.TIMESTAMP_MILLISECOND),
                        ("n", c.v1.ColumnDataType.INT64),
                        ("v", c.v1.ColumnDataType.FLOAT64)],
        time_index="ts", primary_keys=["host"])),
    ("proto typed insert", lambda c: c.proto.insert(
        "proto_ddl_t", {"host": ["a", "b"], "ts": [1000, 1000],
                        "n": [7, -9], "v": [0.5, None]},
        tag_columns=["host"], timestamp_column="ts")),
    ("proto describe", lambda c: _table(c.proto.sql(
        "DESC TABLE proto_ddl_t"))),
    ("proto ddl drop", lambda c: c.proto.drop_table("proto_ddl_t")),
    ("proto select after drop", lambda c: _table(c.proto.sql(
        "SELECT 1 FROM proto_ddl_t"))),
    # DdlRequest{alter} and DeleteRequest stubs: field_bytes(4,
    # field_bytes(3, b"")) and field_bytes(5, b"")
    ("proto alter refused", lambda c: _raw(c, b"\x22\x02\x1a\x00")),
    ("proto delete refused", lambda c: _raw(c, b"\x2a\x00")),
    ("create database", lambda c: c.db.sql("CREATE DATABASE protodb")),
    ("header schema insert", lambda c: c.other.insert(
        "hdr_t", {"host": ["x"], "ts": [1000], "v": [1.0]},
        tag_columns=["host"], timestamp_column="ts")),
    ("header schema select", lambda c: _table(c.other.sql(
        "SELECT count(*) FROM hdr_t"))),
    ("default schema cannot see it", lambda c: _table(c.proto.sql(
        "SELECT count(*) FROM hdr_t"))),
    ("json quickstart create", lambda c: c.db.sql(
        "CREATE TABLE monitor (host STRING, ts TIMESTAMP TIME INDEX, "
        "cpu DOUBLE, memory DOUBLE, PRIMARY KEY(host))")),
    ("json insert", lambda c: c.db.sql(
        "INSERT INTO monitor VALUES ('host1', 1000, 66.6, 1024), "
        "('host2', 1000, 77.7, 2048)")),
    ("json select", lambda c: _batches(c.db.sql(
        "SELECT host, avg(cpu) AS c, max(memory) FROM monitor GROUP BY "
        "host ORDER BY host"))),
    ("json empty select", lambda c: _batches(c.db.sql(
        "SELECT host FROM monitor WHERE cpu > 1000"))),
    ("json row insert auto-create", lambda c: c.db.insert(
        "autotab", {"host": ["a", "b"], "greptime_timestamp": [1, 2],
                    "val": [1.0, 2.0]}, tag_columns=["host"])),
    ("json bulk load auto-alter", lambda c: (c.db.bulk_load(
        "autotab", {"host": ["c"], "greptime_timestamp": [3],
                    "val": [3.0], "extra": [4.0]}, tag_columns=["host"]),
        _batches(c.db.sql("SELECT * FROM autotab ORDER BY host")))),
    ("error: missing table", lambda c: c.db.sql("SELECT * FROM nope")),
    ("error: syntax", lambda c: c.db.sql("SELEC 1")),
    ("error: duplicate create", lambda c: c.db.sql(
        "CREATE TABLE monitor (ts TIMESTAMP TIME INDEX)")),
    ("error: unknown ticket", lambda c: _raw(c, json.dumps(
        {"type": "scan"}).encode())),
    ("error: unknown put", lambda c: c.db._put(
        {"type": "nope"}, __import__("pyarrow").table({"a": [1]}))),
]


def run_steps(client_pkg, address):
    c = clients(client_pkg, address)
    out = []
    try:
        for _, fn in STEPS:
            try:
                out.append(fn(c))
            except Exception as e:  # noqa: BLE001 — the error is the answer
                out.append(_error(e))
    finally:
        for cl in (c.proto, c.db, c.other):
            cl.close()
    return out


@pytest.fixture(scope="module")
def exchange():
    """Every step from each package's clients against each package's
    server: {(client package, server package): answers}."""
    answers = {}
    for server_pkg in ("reference", "port"):
        for client_pkg in ("reference", "port"):
            with tempfile.TemporaryDirectory() as home:
                fe, srv = serve(server_pkg, home)
                try:
                    answers[client_pkg, server_pkg] = run_steps(
                        client_pkg, srv.address)
                finally:
                    srv.shutdown()
                    fe.shutdown()
    return answers


@pytest.mark.parametrize("i", range(len(STEPS)),
                         ids=[name for name, _ in STEPS])
def test_interop_step(exchange, i):
    """Step i: the reference's client against the port's server and the
    port's client against the reference's server answer as each
    package's client does against its own server."""
    want = exchange["reference", "reference"][i]
    assert exchange["port", "port"][i] == want
    assert exchange["reference", "port"][i] == want
    assert exchange["port", "reference"][i] == want


def test_interop_steps_reach_every_kind(exchange):
    """The script is not vacuous: rows came back, affected counts, and
    errors of several types."""
    got = exchange["port", "port"]
    kinds = {a[1] for a in got if isinstance(a, tuple) and a and
             a[0] == "error"}
    assert {"TableNotFoundError", "GreptimeError", "FlightServerError"} <= \
        kinds or len(kinds) >= 3, kinds
    assert got[0] == 3 and got[2] == (None, 1)
    assert got[1][1]["cpu"] == [0.5, None, 0.7]
