"""Arrow Flight data plane: the client↔server transport.

Reference behavior: src/servers/src/grpc/flight.rs:40-120 — the gRPC
service exposes Arrow Flight `do_get` carrying an encoded request ticket
and streams record batches back; src/client/src/database.rs:209-260 is the
matching client. Here the same plane is built directly on
`pyarrow.flight` (Flight *is* gRPC + Arrow IPC):

- `FlightFrontendServer` wraps a frontend and serves user SQL over
  `do_get` (JSON tickets and greptime-proto `GreptimeRequest` tickets) +
  gRPC-style row inserts and bulk loads with auto-create/alter over
  `do_put` (reference: src/frontend/src/instance.rs:292-342).

Tickets, descriptors and action bodies are JSON; data rides Arrow IPC.

Ported from greptimedb_tpu/servers/flight.py: the shared helpers and the
frontend server. The datanode half (`FlightDatanodeServer`, the
router↔worker plane) comes with the distributed frontend and datanode
(ROADMAP Queue 1 h1/h3); the helpers it shares (`_apply_wire_verdicts`,
`_export_spans`, `_frames_stream`, `EXEC_STATS_KEY`, `_slow_logger`) are
here already.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Dict, Optional

import pyarrow as pa
import pyarrow.flight as flight

from ..common import exec_stats
from ..common.telemetry import remote_context
from ..datatypes.schema import Schema
from ..errors import GreptimeError

_EMPTY_SCHEMA = pa.schema([])

#: wire key for the datanode-side ExecStats riding a response (stream
#: schema metadata on do_get, the JSON ack on do_put)
EXEC_STATS_KEY = exec_stats.EXEC_STATS_WIRE_KEY

#: same logger as the frontend's slow-query log, so one `grep trace=`
#: finds a slow distributed statement on every process it touched
_slow_logger = logging.getLogger("greptimedb_tpu_torch.slow_query")


def _apply_wire_verdicts(body: dict) -> None:
    """Tail-sampling verdicts piggybacked on an inbound RPC body: pop
    the key (handlers must not see it) and release/discard the matching
    buffered traces on this process's sink."""
    from ..common import trace_store
    verdicts = body.pop(trace_store.TRACE_VERDICTS_BODY_KEY, None)
    sink = trace_store.sink()
    if sink is None or not isinstance(verdicts, dict) or not verdicts:
        return
    try:
        sink.apply_verdicts({str(k): bool(v)
                             for k, v in verdicts.items()})
    except Exception:  # noqa: BLE001 — advisory; never fail the RPC
        logging.getLogger(__name__).exception(
            "trace verdict application failed")


def _export_spans() -> list:
    """Retained spans awaiting the trip home — they ride this RPC's
    response to the frontend, which writes them into
    greptime_private.trace_spans."""
    from ..common import trace_store
    sink = trace_store.sink()
    return sink.take_export() if sink is not None else []


def _advertised_address(location: str, port: int) -> str:
    """Dialable address for peers: the bound host with the real port
    (port 0 in the location means OS-assigned)."""
    host = location.split("://", 1)[-1].rsplit(":", 1)[0] or "127.0.0.1"
    if host == "0.0.0.0":
        import socket
        host = socket.gethostbyname(socket.gethostname())
    return f"grpc://{host}:{port}"


# ---------------------------------------------------------------------------
# request codecs (JSON-safe)
# ---------------------------------------------------------------------------

def _arrow_to_columns(table: pa.Table) -> Dict[str, list]:
    return {name: table.column(i).to_pylist()
            for i, name in enumerate(table.schema.names)}


def _with_metadata(schema: pa.Schema,
                   metadata: Optional[Dict[bytes, bytes]]) -> pa.Schema:
    if not metadata:
        return schema
    merged = dict(schema.metadata or {})
    merged.update(metadata)
    return schema.with_metadata(merged)


def _frames_stream(frames, metadata: Optional[Dict[bytes, bytes]] = None
                   ) -> flight.GeneratorStream:
    """One moment frame = one IPC batch, so per-region frame boundaries
    survive the wire and the frontend fold sees the same units as the
    in-process path. `metadata` rides the stream schema (the datanode's
    ExecStats travel there)."""
    if not frames:
        return flight.GeneratorStream(
            _with_metadata(_EMPTY_SCHEMA, metadata), iter(()))
    schema0 = _with_metadata(
        pa.Schema.from_pandas(frames[0], preserve_index=False), metadata)

    def gen():
        for f in frames:
            t = pa.Table.from_pandas(f, schema=schema0,
                                     preserve_index=False)
            yield t.combine_chunks().to_batches(
                max_chunksize=max(1, len(f)))[0]
    return flight.GeneratorStream(schema0, gen())


def _batches_stream(batches, fallback_schema: Optional[Schema] = None,
                    metadata: Optional[Dict[bytes, bytes]] = None
                    ) -> flight.GeneratorStream:
    if not batches:
        schema = fallback_schema.to_arrow() if fallback_schema is not None \
            else _EMPTY_SCHEMA
        return flight.GeneratorStream(_with_metadata(schema, metadata),
                                      iter(()))
    schema = _with_metadata(batches[0].schema.to_arrow(), metadata)
    return flight.GeneratorStream(
        schema, (b.to_arrow() for b in batches))


_AFFECTED_SCHEMA = pa.schema([("affected_rows", pa.int64())],
                             metadata={b"gdb.kind": b"affected_rows"})


def _affected_stream(n: int,
                     proto_metadata: bool = False) -> flight.GeneratorStream:
    batch = pa.RecordBatch.from_arrays([pa.array([n], pa.int64())],
                                       schema=_AFFECTED_SCHEMA)
    if proto_metadata:
        # greptime-proto clients read the row count from
        # FlightData.app_metadata (FlightMetadata{affected_rows},
        # reference common/grpc/src/flight.rs:84-120)
        from ..api.v1 import encode_affected_rows_metadata
        meta = pa.py_buffer(encode_affected_rows_metadata(n))
        return flight.GeneratorStream(_AFFECTED_SCHEMA,
                                      iter([(batch, meta)]))
    return flight.GeneratorStream(_AFFECTED_SCHEMA, iter([batch]))


# ---------------------------------------------------------------------------
# frontend server (user-facing SQL-over-Flight, the reference's
# GreptimeService + FlightService pair)
# ---------------------------------------------------------------------------

class FlightFrontendServer(flight.FlightServerBase):
    def __init__(self, frontend, location: str = "grpc://127.0.0.1:0"):
        super().__init__(location)
        self.frontend = frontend
        self._location = location

    @property
    def address(self) -> str:
        return _advertised_address(self._location, self.port)

    def serve_in_background(self) -> threading.Thread:
        from ..common.runtime import new_thread
        t = new_thread(self.serve, daemon=True, name="flight-frontend",
                       propagate_context=False)
        t.start()
        return t

    def do_get(self, context, ticket):
        raw = ticket.ticket
        try:
            cmd = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            # greptime-proto plane: reference SDKs serialize a
            # GreptimeRequest protobuf into the ticket
            # (src/client/src/database.rs:209-231, decoded by the
            # server at src/servers/src/grpc/flight.rs:87-96)
            return self._do_get_proto(raw)
        if cmd.get("type") != "sql":
            raise GreptimeError(f"unsupported ticket {cmd.get('type')!r}")
        with remote_context(cmd.get("traceparent")):
            outputs = self.frontend.do_query(cmd["sql"])
        last = outputs[-1]
        if last.is_batches:
            return _batches_stream(last.batches)
        return _affected_stream(last.affected_rows or 0)

    def _do_get_proto(self, raw: bytes):
        from ..api import v1 as proto
        req = proto.decode_greptime_request(bytes(raw))
        ctx = self._proto_ctx(req)
        if req.query is not None and req.query.sql is not None:
            outputs = self.frontend.do_query(req.query.sql, ctx)
            last = outputs[-1]
            if last.is_batches:
                return _batches_stream(last.batches)
            return _affected_stream(last.affected_rows or 0,
                                    proto_metadata=True)
        if req.insert is not None:
            n = self._apply_proto_insert(req.insert, ctx)
            return _affected_stream(n, proto_metadata=True)
        if req.ddl is not None:
            return self._apply_proto_ddl(req.ddl, ctx)
        what = req.other or "empty"
        raise GreptimeError(
            f"unsupported GreptimeRequest variant {what!r} on do_get "
            "(use SQL DDL over the query plane)")

    @staticmethod
    def _proto_ctx(req):
        """RequestHeader catalog/schema/dbname → QueryContext (reference:
        every handler resolves names through the header's context,
        src/servers/src/grpc/handler.rs). dbname may carry
        'catalog-schema' form."""
        from ..session import QueryContext
        ctx = QueryContext()
        catalog, schema = req.catalog, req.schema
        if req.dbname:
            if "-" in req.dbname:
                catalog, _, schema = req.dbname.partition("-")
            else:
                schema = req.dbname
        if catalog:
            ctx.current_catalog = catalog
        if schema:
            ctx.current_schema = schema
        return ctx

    def _apply_proto_ddl(self, ddl, ctx):
        from ..api.v1 import create_table_to_sql
        if ddl.create_table is not None:
            sql = create_table_to_sql(ddl.create_table)
        elif ddl.drop_table is not None:
            sql = f'DROP TABLE "{ddl.drop_table[2]}"'
        elif ddl.create_database is not None:
            sql = f'CREATE DATABASE "{ddl.create_database}"'
        else:
            raise GreptimeError(
                f"unsupported DdlRequest variant {ddl.other!r}")
        outputs = self.frontend.do_query(sql, ctx)
        return _affected_stream(outputs[-1].affected_rows or 0,
                                proto_metadata=True)

    def _apply_proto_insert(self, ins, ctx) -> int:
        from ..api.v1 import SemanticType
        columns = {}
        tag_columns = []
        timestamp_column = "greptime_timestamp"
        for c in ins.columns:
            columns[c.column_name] = c.rows(ins.row_count)
            if c.semantic_type == SemanticType.TAG:
                tag_columns.append(c.column_name)
            elif c.semantic_type == SemanticType.TIMESTAMP:
                timestamp_column = c.column_name
        return self.frontend.handle_row_insert(
            ins.table_name, columns, tag_columns=tag_columns,
            timestamp_column=timestamp_column, ctx=ctx)

    def do_put(self, context, descriptor, reader, writer):
        cmd = json.loads(descriptor.command)
        kind = cmd.get("type")
        # same contract as do_get's ticket: the descriptor command may
        # carry the writer's W3C traceparent, so bulk writes stitch onto
        # the client's trace like queries do
        with remote_context(cmd.get("traceparent")):
            self._do_put_cmd(cmd, kind, reader, writer)

    def _do_put_cmd(self, cmd, kind, reader, writer):
        if kind == "row_insert":
            columns = _arrow_to_columns(reader.read_all())
            n = self.frontend.handle_row_insert(
                cmd["table"], columns,
                tag_columns=cmd.get("tag_columns", ()),
                timestamp_column=cmd.get("timestamp_column",
                                         "greptime_timestamp"))
        elif kind == "bulk_load":
            # WAL-less bulk path: keep columns arrow→ndarray end to end
            # when the table already exists (the bulk_ingest raw fast
            # path); fall back to python lists for auto-create inference
            from ..datatypes.record_batch import arrow_to_ingest_columns
            tbl = reader.read_all()
            from ..session import QueryContext
            ctx = QueryContext()
            target = self.frontend.catalog.table(
                ctx.current_catalog, ctx.current_schema, cmd["table"])
            columns = _arrow_to_columns(tbl) if target is None else \
                arrow_to_ingest_columns(tbl, target.schema, extra="keep")
            n = self.frontend.handle_bulk_load(
                cmd["table"], columns,
                tag_columns=cmd.get("tag_columns", ()),
                timestamp_column=cmd.get("timestamp_column",
                                         "greptime_timestamp"), ctx=ctx)
        else:
            raise GreptimeError(f"unsupported put {kind!r}")
        writer.write(pa.py_buffer(
            json.dumps({"affected_rows": n}).encode()))
