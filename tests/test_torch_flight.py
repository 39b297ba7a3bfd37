"""Differential tests of the port's Flight front door and its client.

greptimedb_tpu_torch/servers/{flight,grpc}.py and client/flight.py
against the reference's. The reference's own cases
(tests/test_flight.py's `Database` quick start, row insert with
auto-create and do_put trace propagation; tests/test_bulk_load.py's
Flight bulk load with auto-alter) run on both packages and give the same
answers; the shared helpers (stream builders, advertised addresses,
wire verdicts and spans, the client's trace context, stream stats and
error mapping) behave alike; `GrpcServer` wraps the Flight server with
the CLI's lifecycle.
"""

import json
import time
import types

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.flight as flight
import pytest

from greptimedb_tpu.client import flight as ref_client
from greptimedb_tpu.common import exec_stats as ref_exec_stats
from greptimedb_tpu.common import telemetry as ref_tel
from greptimedb_tpu.common import trace_store as ref_trace_store
from greptimedb_tpu.servers import flight as ref_flight
from greptimedb_tpu.servers import grpc as ref_grpc
from greptimedb_tpu_torch.client import flight as port_client
from greptimedb_tpu_torch.common import exec_stats as port_exec_stats
from greptimedb_tpu_torch.common import telemetry as port_tel
from greptimedb_tpu_torch.common import trace_store as port_trace_store
from greptimedb_tpu_torch.servers import flight as port_flight
from greptimedb_tpu_torch.servers import grpc as port_grpc

SIDES = {
    "reference": types.SimpleNamespace(
        client=ref_client, flight=ref_flight, grpc=ref_grpc, tel=ref_tel,
        trace_store=ref_trace_store, exec_stats=ref_exec_stats),
    "port": types.SimpleNamespace(
        client=port_client, flight=port_flight, grpc=port_grpc,
        tel=port_tel, trace_store=port_trace_store,
        exec_stats=port_exec_stats),
}


def _wait_port(server, timeout=10.0):
    t0 = time.time()
    while server.port == 0 and time.time() - t0 < timeout:
        time.sleep(0.01)
    assert server.port != 0


def frontend(side, home):
    if side == "reference":
        from greptimedb_tpu.datanode.instance import (
            DatanodeInstance, DatanodeOptions)
        from greptimedb_tpu.frontend.instance import FrontendInstance
        opts = DatanodeOptions(data_home=home, register_numbers_table=False)
    else:
        from greptimedb_tpu_torch.datanode import (
            DatanodeInstance, DatanodeOptions)
        from greptimedb_tpu_torch.frontend import FrontendInstance
        opts = DatanodeOptions(data_home=home, register_numbers_table=False,
                               device="cpu")
    dn = DatanodeInstance(opts)
    dn.start()
    fe = FrontendInstance(dn)
    fe.start()
    return fe


@pytest.fixture()
def standalone(tmp_path):
    """Per side: a frontend behind its FlightFrontendServer and a
    Database client of the same package."""
    opened = {}
    for side, m in SIDES.items():
        fe = frontend(side, str(tmp_path / side))
        srv = m.flight.FlightFrontendServer(fe)
        srv.serve_in_background()
        _wait_port(srv)
        opened[side] = types.SimpleNamespace(
            fe=fe, srv=srv, db=m.client.Database(srv.address))
    yield opened
    for o in opened.values():
        o.db.close()
        o.srv.shutdown()
        o.fe.shutdown()


def rows(batches):
    return [tuple(r) for b in batches for r in b.rows()]


def test_quickstart_flow(standalone):
    """tests/test_flight.py::test_quickstart_flow on both packages."""
    got = {}
    for side, o in standalone.items():
        db = o.db
        created = db.sql(
            "CREATE TABLE monitor (host STRING, ts TIMESTAMP TIME INDEX,"
            " cpu DOUBLE, memory DOUBLE, PRIMARY KEY(host))")
        n = db.sql("INSERT INTO monitor VALUES "
                   "('host1', 1000, 66.6, 1024), "
                   "('host2', 1000, 77.7, 2048)")
        batches = db.sql("SELECT host, avg(cpu) AS c FROM monitor "
                         "GROUP BY host ORDER BY host")
        got[side] = (created, n, rows(batches),
                     [str(f) for f in batches[0].to_arrow().schema])
    assert got["port"] == got["reference"]
    assert got["port"][:3] == (0, 2, [("host1", 66.6), ("host2", 77.7)])


def test_row_insert_auto_create(standalone):
    """tests/test_flight.py::test_row_insert_auto_create on both."""
    got = {}
    for side, o in standalone.items():
        n = o.db.insert("autotab",
                        {"host": ["a", "b"], "greptime_timestamp": [1, 2],
                         "val": [1.0, 2.0]}, tag_columns=["host"])
        batches = o.db.sql("SELECT count(val) AS n FROM autotab")
        desc = rows(o.db.sql("DESC TABLE autotab"))
        got[side] = (n, next(batches[0].rows())[0], desc)
    assert got["port"] == got["reference"]
    assert got["port"][:2] == (2, 2)


def test_flight_bulk_load_auto_alter(standalone):
    """tests/test_bulk_load.py::test_flight_bulk_load_auto_alter on both:
    a new field column on an existing table is added, not dropped; a
    load of numpy columns into the existing table takes the arrow path."""
    got = {}
    for side, o in standalone.items():
        db = o.db
        n1 = db.bulk_load("bk", {
            "host": ["a", "b"], "greptime_timestamp": [1000, 2000],
            "val": [1.0, 2.0]}, tag_columns=["host"])
        n2 = db.bulk_load("bk", {
            "host": ["c"], "greptime_timestamp": [3000],
            "val": [3.0], "extra": [42.0]}, tag_columns=["host"])
        n3 = db.bulk_load("bk", {
            "host": np.array(["d", "e"], dtype=object),
            "greptime_timestamp": np.array([4000, 5000]),
            "val": np.array([4.0, np.nan]), "extra": np.array([1.5, 2.5])},
            tag_columns=["host"])
        got[side] = (n1, n2, n3, rows(db.sql(
            "SELECT host, val, extra FROM bk ORDER BY host")))
    assert got["port"] == got["reference"]
    assert got["port"][3][:3] == [("a", 1.0, None), ("b", 2.0, None),
                                  ("c", 3.0, 42.0)]


@pytest.mark.parametrize("via", ["insert", "bulk_load", "sql"])
def test_client_trace_reaches_the_server(standalone, via):
    """tests/test_flight.py::test_do_put_joins_client_trace on both
    packages, and the same for bulk loads and do_get: the handler runs
    inside the client's trace."""
    for side, o in standalone.items():
        tel = SIDES[side].tel
        o.db.sql("CREATE TABLE traced_tab (host STRING, greptime_timestamp "
                 "TIMESTAMP TIME INDEX, val DOUBLE, PRIMARY KEY(host))")
        server_side = []
        name = {"insert": "handle_row_insert",
                "bulk_load": "handle_bulk_load", "sql": "do_query"}[via]
        orig = getattr(o.fe, name)

        def spy(*args, _orig=orig, _tel=tel, **kwargs):
            server_side.append(_tel.current_traceparent())
            return _orig(*args, **kwargs)

        setattr(o.fe, name, spy)
        with tel.span("client-bulk-write"):
            client_tp = tel.current_traceparent()
            if via == "sql":
                n = o.db.sql("SELECT count(*) FROM traced_tab")
            else:
                n = getattr(o.db, via)(
                    "traced_tab", {"host": ["a"], "greptime_timestamp": [1],
                                   "val": [1.0]}, tag_columns=["host"])
        assert n == 1 or rows(n) == [(0,)], side
        assert server_side and server_side[0] is not None, side
        assert tel.parse_traceparent(server_side[0])[0] == \
            tel.parse_traceparent(client_tp)[0], side


def test_grpc_server_lifecycle(tmp_path):
    """GrpcServer: the CLI's start / port / shutdown over the Flight
    frontend server, on an address with and without a host."""
    got = {}
    for side, m in SIDES.items():
        fe = frontend(side, str(tmp_path / side))
        out = []
        try:
            for addr in ("127.0.0.1:0", ":0"):
                srv = m.grpc.GrpcServer(fe, None, addr)
                thread = srv.start()
                _wait_port(srv)
                db = m.client.Database(f"grpc://127.0.0.1:{srv.port}")
                out.append((srv.host, type(thread).__name__,
                            thread.daemon, thread.name,
                            rows(db.sql("SELECT 1 + 1"))))
                db.close()
                srv.shutdown()
        finally:
            fe.shutdown()
        got[side] = out
    assert got["port"] == got["reference"]
    assert got["port"][1][0] == "127.0.0.1"


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("location,port", [
    ("grpc://127.0.0.1:0", 4001), ("grpc://10.0.0.2:7", 7),
    ("grpc://:0", 5), ("localhost:9", 9)])
def test_advertised_address(location, port):
    got = {side: m.flight._advertised_address(location, port)
           for side, m in SIDES.items()}
    assert got["port"] == got["reference"]


class StreamServer(flight.FlightServerBase):
    """Serves whatever stream `make` returns, to read a helper's
    GeneratorStream back through a real client."""

    def __init__(self, make):
        super().__init__("grpc://127.0.0.1:0")
        self.make = make

    def do_get(self, context, ticket):
        return self.make()


def _read_stream(make):
    srv = StreamServer(make)
    try:
        client = flight.FlightClient(f"grpc://127.0.0.1:{srv.port}")
        reader = client.do_get(flight.Ticket(b"x"))
        chunks = []
        while True:
            try:
                chunk = reader.read_chunk()
            except StopIteration:
                break
            chunks.append((
                chunk.data.to_pydict() if chunk.data is not None else None,
                chunk.app_metadata.to_pybytes()
                if chunk.app_metadata is not None else None))
        out = (str(reader.schema), dict(reader.schema.metadata or {}),
               chunks)
        client.close()
        return out
    finally:
        srv.shutdown()


def _frames():
    return [pd.DataFrame({"k": ["a", "b"], "sum": [1.5, 2.0],
                          "count": np.array([2, 3], dtype=np.int64)}),
            pd.DataFrame({"k": ["c"], "sum": [4.0],
                          "count": np.array([1], dtype=np.int64)})]


def _batches(side):
    from importlib import import_module
    pkg = "greptimedb_tpu" if side == "reference" else "greptimedb_tpu_torch"
    RecordBatch = import_module(f"{pkg}.datatypes.record_batch").RecordBatch
    return [RecordBatch.from_arrow(pa.record_batch(
        {"h": ["x", "y"], "v": [1.0, None]})),
            RecordBatch.from_arrow(pa.record_batch(
                {"h": ["z"], "v": [3.0]}))]


META = {b"gdb.exec_stats": b'{"rows": 3}'}
STREAMS = {
    "affected": lambda m, side: m.flight._affected_stream(7),
    "affected_proto": lambda m, side: m.flight._affected_stream(
        2 ** 31, proto_metadata=True),
    "frames": lambda m, side: m.flight._frames_stream(_frames(), META),
    "frames_empty": lambda m, side: m.flight._frames_stream([], META),
    "batches": lambda m, side: m.flight._batches_stream(_batches(side)),
    "batches_meta": lambda m, side: m.flight._batches_stream(
        _batches(side), metadata=META),
    "batches_empty": lambda m, side: m.flight._batches_stream([]),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_streams_read_back_equal(name):
    """The stream builders give the same schema, metadata, batches and
    app_metadata through a real Flight client."""
    got = {side: _read_stream(lambda: STREAMS[name](m, side))
           for side, m in SIDES.items()}
    assert got["port"] == got["reference"]


def test_with_metadata():
    schema = pa.schema([("a", pa.int64())], metadata={b"x": b"1"})
    for meta in (None, {}, {b"y": b"2"}, {b"x": b"3"}):
        assert port_flight._with_metadata(schema, meta) == \
            ref_flight._with_metadata(schema, meta)
        got = port_flight._with_metadata(schema, meta).metadata
        assert got == ref_flight._with_metadata(schema, meta).metadata


class FakeSink:
    """Stands in for a process's trace sink: records what the helpers
    hand it and hands back fixed spans and verdicts."""

    def __init__(self, role="root"):
        self.role = role
        self.calls = []

    def apply_verdicts(self, v):
        self.calls.append(("apply_verdicts", v))

    def take_export(self):
        self.calls.append(("take_export",))
        return [{"span_id": "s1"}]

    def recent_verdicts(self):
        return {"t1": True, "t2": False}

    def absorb_spans(self, rows):
        self.calls.append(("absorb_spans", rows))


@pytest.mark.parametrize("role", [None, "root", "buffer"])
def test_wire_verdicts_spans_and_trace_context(monkeypatch, role):
    """`_apply_wire_verdicts` pops the verdicts and hands them to the
    sink; `_export_spans` drains it; the client's `_traced` attaches the
    caller's traceparent and, from a root sink, its recent verdicts;
    `_absorb_stream_stats` replays stream-schema stats and spans."""
    got = {}
    for side, m in SIDES.items():
        sink = FakeSink(role) if role else None
        monkeypatch.setattr(m.trace_store, "sink", lambda s=sink: s)
        absorbed = []
        monkeypatch.setattr(m.exec_stats, "absorb_remote", absorbed.append)
        key = m.trace_store.TRACE_VERDICTS_BODY_KEY
        body = {"a": 1, key: {"t9": 1, "t8": 0}}
        m.flight._apply_wire_verdicts(body)
        bad = {"a": 1, key: ["not", "a", "dict"]}
        m.flight._apply_wire_verdicts(bad)
        exported = m.flight._export_spans()
        plain = m.client._traced({"type": "sql"})
        with m.tel.span("caller"):
            traced = m.client._traced({"type": "sql"})
            tp = m.tel.current_traceparent()
        schema = pa.schema([("a", pa.int64())], metadata={
            m.exec_stats.EXEC_STATS_WIRE_KEY: b'{"rows": 3}',
            m.trace_store.TRACE_SPANS_WIRE_KEY: b'[{"span_id": "x"}]'})
        m.client._absorb_stream_stats(schema)
        m.client._absorb_stream_stats(pa.schema([], metadata={
            m.exec_stats.EXEC_STATS_WIRE_KEY: b"not json"}))
        got[side] = (body, bad, exported, plain,
                     {k: v for k, v in traced.items() if k != "traceparent"},
                     traced.get("traceparent") == tp, absorbed,
                     sink.calls if sink else None)
    assert got["port"] == got["reference"]
    assert got["port"][0] == {"a": 1}


@pytest.mark.parametrize("error,message", [
    ("FlightUnavailableError", "connection refused"),
    ("FlightTimedOutError", "deadline"),
    ("FlightServerError", "stale route: region 3 moved"),
    ("FlightServerError", "server overloaded: 8 in flight"),
    ("FlightServerError", "unsupported shipped plan v9"),
    ("FlightServerError", "table greptime.public.t not found"),
    ("FlightServerError", "region 4 not on datanode 2"),
    ("FlightServerError", "syntax error at 0"),
    ("FlightInternalError", "boom. gRPC client debug context: xyz"),
])
def test_errors_rebuild_as_the_same_types(error, message):
    """`_to_greptime_error`: each wire error comes back as the same
    member of the error taxonomy with the same message."""
    got = {}
    for side, m in SIDES.items():
        e = m.client._to_greptime_error(getattr(flight, error)(message))
        got[side] = (type(e).__name__, str(e))
    assert got["port"] == got["reference"]


class ActionServer(flight.FlightServerBase):
    """Answers every action with the JSON body its type names, to read
    how a client's `_action` takes a reply."""

    REPLIES = {
        "ok": {"ok": True, "n": 3, "trace_spans": [{"span_id": "a"}]},
        "table": {"ok": False, "error": "t not found",
                  "error_type": "TableNotFoundError"},
        "route": {"ok": False, "error": "moved",
                  "error_type": "StaleRouteError"},
        "busy": {"ok": False, "error": "8 in flight",
                 "error_type": "OverloadedError"},
        "other": {"ok": False, "error": "boom", "error_type": "ValueError"},
        "bare": {},
    }

    def __init__(self):
        super().__init__("grpc://127.0.0.1:0")
        self.bodies = []

    def do_action(self, context, action):
        self.bodies.append(json.loads(action.body.to_pybytes()))
        if action.type == "raise":
            raise flight.FlightUnavailableError("down")
        yield flight.Result(json.dumps(self.REPLIES[action.type]).encode())


@pytest.mark.parametrize("kind", list(ActionServer.REPLIES) + ["raise"])
def test_action_replies_map_alike(monkeypatch, kind):
    """`_FlightBase._action`: a reply's error_type comes back as the same
    error, spans riding the reply go to the sink, and the request body
    carries the caller's traceparent."""
    got = {}
    for side, m in SIDES.items():
        sink = FakeSink()
        monkeypatch.setattr(m.trace_store, "sink", lambda s=sink: s)
        srv = ActionServer()
        base = m.client._FlightBase(f"grpc://127.0.0.1:{srv.port}")
        with m.tel.span("caller"):
            tp = m.tel.current_traceparent()
            try:
                out = ("ok", base._action(kind, {"table": "t"}))
            except Exception as e:  # noqa: BLE001 — the error is the answer
                out = (type(e).__name__, str(e).split(". gRPC client")[0])
            finally:
                base.close()
                srv.shutdown()
        body = srv.bodies[0]
        got[side] = (out, {k: v for k, v in body.items()
                           if k != "traceparent"},
                     body.get("traceparent") == tp, sink.calls)
    assert got["port"] == got["reference"]


COLUMNS = {
    "lists": {"h": ["a", None], "ts": [1, 2], "v": [1.5, float("nan")],
              "b": [True, False]},
    "numpy": {"h": np.array(["a", None], dtype=object),
              "ts": np.array([1, 2]), "v": np.array([1.5, np.nan]),
              "f": np.array([0.5, 1.0], dtype=np.float32),
              "u": np.array([1, 2], dtype=np.uint8),
              "b": np.array([True, False])},
    "mixed": {"h": ("x", "y"), "v": np.array([1.0, 2.0]),
              "t": pd.Series([3, 4])},
}


@pytest.mark.parametrize("name", list(COLUMNS))
def test_columns_to_arrow_equal(name):
    """The client's columns become the same arrow table (the port hands
    numpy columns to arrow whole, the reference element by element)."""
    got = {side: m.client._columns_to_arrow(COLUMNS[name])
           for side, m in SIDES.items()}
    assert got["port"].schema == got["reference"].schema
    assert got["port"].to_pydict().__repr__() == \
        got["reference"].to_pydict().__repr__()


def test_slow_query_logger_is_the_frontends():
    """The Flight module logs slow operations under the frontend's
    slow-query logger, each package under its own name."""
    from greptimedb_tpu.frontend import instance as ref_fe
    from greptimedb_tpu_torch.frontend import instance as port_fe
    assert port_flight._slow_logger is port_fe._slow_logger
    assert ref_flight._slow_logger is ref_fe._slow_logger
    assert port_flight.EXEC_STATS_KEY == ref_flight.EXEC_STATS_KEY
