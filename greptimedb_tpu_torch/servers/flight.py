"""Arrow Flight data plane: the client↔server transport.

Reference behavior: src/servers/src/grpc/flight.rs:40-120 — the gRPC
service exposes Arrow Flight `do_get` carrying an encoded request ticket
and streams record batches back; src/client/src/database.rs:209-260 is the
matching client. Here the same plane is built directly on
`pyarrow.flight` (Flight *is* gRPC + Arrow IPC):

- `FlightDatanodeServer` wraps a `DatanodeInstance` and exposes the
  `DatanodeClient` surface over the wire: DDL actions, `do_put` region
  writes, `do_get` scans / pushed-down aggregate moments (the datanode's
  `segment_moments` launches run on the server's Flight threads). This
  is the multi-host version of the in-process router↔worker calls
  (client/__init__.py).
- `FlightFrontendServer` wraps a frontend and serves user SQL over
  `do_get` (JSON tickets and greptime-proto `GreptimeRequest` tickets) +
  gRPC-style row inserts and bulk loads with auto-create/alter over
  `do_put` (reference: src/frontend/src/instance.rs:292-342).

Tickets, descriptors and action bodies are JSON; data rides Arrow IPC.

Ported from greptimedb_tpu/servers/flight.py; its tickets, descriptors
and action bodies are the reference's, so either package's client talks
to either's server, the `repl_*` actions of read-replica shipping
included. Unlike the reference's, each server's `shutdown()` waits for
the thread `serve_in_background` started.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Dict, Optional

import pyarrow as pa
import pyarrow.flight as flight

from ..common import exec_stats
from ..common.telemetry import (
    remote_context, slow_query_threshold_ms, span)
from ..datatypes.schema import Schema
from ..errors import GreptimeError
from ..table.requests import create_request_from_dict

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
# datanode server (worker side of the distributed data plane)
# ---------------------------------------------------------------------------

class FlightDatanodeServer(flight.FlightServerBase):
    """Serves one datanode's region data plane over Arrow Flight."""

    def __init__(self, datanode, location: str = "grpc://127.0.0.1:0"):
        super().__init__(location)
        from ..client import LocalDatanodeClient
        self.datanode = datanode
        self.local = LocalDatanodeClient(datanode)
        self._location = location

    @property
    def address(self) -> str:
        return _advertised_address(self._location, self.port)

    def serve_in_background(self) -> threading.Thread:
        from ..common.runtime import new_thread
        t = new_thread(self.serve, daemon=True,
                       name=f"flight-dn{self.datanode.opts.node_id}",
                       propagate_context=False)
        t.start()
        self._serving = t
        return t

    def shutdown(self) -> None:
        """Shut down, then wait for the serve thread to return: a Flight
        server whose serve() is still winding down can close the
        listening socket of a server made after it in the same process
        (pyarrow 25)."""
        super().shutdown()
        t = getattr(self, "_serving", None)
        if t is not None and t is not threading.current_thread():
            t.join()

    # ---- control plane: DDL / flush / describe ----
    def do_action(self, context, action):
        body = json.loads(action.body.to_pybytes() or b"{}")
        kind = action.type
        _apply_wire_verdicts(body)
        # join the caller's trace before any handler work so DDL/flush
        # spans and logs carry the frontend's trace id
        with remote_context(body.pop("traceparent", None)), \
                span(f"dn_{kind}", node=self.datanode.opts.node_id):
            yield from self._do_action_inner(kind, body)

    def _do_action_inner(self, kind, body):
        try:
            if kind == "ddl_create_table":
                self.local.ddl_create_table(
                    create_request_from_dict(body["request"]))
                resp = {"ok": True}
            elif kind == "ddl_alter_table":
                from ..table.requests import alter_request_from_dict
                self.local.ddl_alter_table(
                    alter_request_from_dict(body["request"]))
                resp = {"ok": True}
            elif kind == "ddl_drop_table":
                dropped = self.local.ddl_drop_table(
                    body["catalog"], body["schema"], body["table"])
                resp = {"ok": True, "dropped": bool(dropped)}
            elif kind == "flush_table":
                self.local.flush_table(body["catalog"], body["schema"],
                                       body["table"])
                resp = {"ok": True}
            elif kind == "describe_table":
                described = self.local.describe_table(
                    body["catalog"], body["schema"], body["table"])
                if described is None:
                    resp = {"ok": True, "info": None}
                else:
                    info, _rule = described
                    resp = {"ok": True, "info": info.to_dict()}
            elif kind == "ping":
                resp = {"ok": True, "node_id": self.datanode.opts.node_id}
            elif kind == "repl_apply":
                # continuous replication consumer: apply shipped WAL
                # records to this node's standby replica of the region
                applied = self.local.repl_apply(
                    body["catalog"], body["schema"], body["table"],
                    int(body["region_number"]),
                    list(body.get("entries") or []),
                    leader_flushed=int(body.get("leader_flushed") or 0))
                resp = {"ok": True, **applied}
            elif kind == "background_jobs":
                # live + recent background work on THIS node, for the
                # frontend's cluster-merged information_schema view
                from ..common import background_jobs
                resp = {"ok": True, "jobs": background_jobs.rows()}
            elif kind == "profile":
                # continuous profiler, datanode side: writer-less
                # sampler — {"drain": true} hands the pending aggregate
                # to the frontend (which owns the flush), {"seconds":
                # N[, "hz": h]} runs a high-rate burst for /debug/prof
                from ..common import profiler
                s = profiler.sampler()
                if s is None:
                    resp = {"ok": True, "rows": []}
                elif body.get("seconds") is not None:
                    resp = {"ok": True, "rows": s.collect_burst(
                        float(body["seconds"]),
                        burst_hz=body.get("hz"))}
                else:
                    resp = {"ok": True, "rows": s.drain_rows()}
            else:
                raise GreptimeError(f"unknown action {kind!r}")
        except GreptimeError as e:
            resp = {"ok": False, "error": str(e),
                    "error_type": type(e).__name__}
        exported = _export_spans()
        if exported:
            resp["trace_spans"] = exported
        yield flight.Result(json.dumps(resp).encode())

    # ---- write plane ----
    def do_put(self, context, descriptor, reader, writer):
        cmd = json.loads(descriptor.command)
        if cmd.get("type") != "write_region":
            raise GreptimeError(f"unsupported put {cmd.get('type')!r}")
        _apply_wire_verdicts(cmd)
        stats = exec_stats.ExecStats()
        t0 = time.perf_counter()
        with remote_context(cmd.get("traceparent")), \
                span("dn_write_region", node=self.datanode.opts.node_id,
                     table=cmd.get("table")) as sp, \
                exec_stats.collect(stats):
            tbl = reader.read_all()
            op = cmd.get("op", "put")
            target = self.datanode.catalog.table(
                cmd["catalog"], cmd["schema"], cmd["table"]) \
                if op == "bulk" else None
            if target is not None:
                # bulk path: typed ndarray columns feed bulk_ingest's raw
                # fast path instead of a per-value pylist round trip
                from ..datatypes.record_batch import arrow_to_ingest_columns
                columns = arrow_to_ingest_columns(tbl, target.schema)
            else:
                columns = _arrow_to_columns(tbl)
            n = self.local.write_region(
                cmd["catalog"], cmd["schema"], cmd["table"],
                cmd["region_number"], columns, op=op)
        self._log_slow(sp, "write_region", cmd,
                       (time.perf_counter() - t0) * 1e3, stats)
        ack = {"affected_rows": n, "exec_stats": stats.to_dict()}
        exported = _export_spans()
        if exported:
            ack["trace_spans"] = exported
        writer.write(pa.py_buffer(json.dumps(ack).encode()))

    def _log_slow(self, sp, what: str, cmd: dict, elapsed_ms: float,
                  stats: exec_stats.ExecStats) -> None:
        """Datanode-side slow-op log: after wire trace propagation this
        reports the SAME trace id as the frontend's slow-query entry for
        the statement that caused the RPC."""
        thr = slow_query_threshold_ms()
        if thr is None or elapsed_ms < thr:
            return
        _slow_logger.warning(
            "slow datanode op: %s %.1fms (threshold %dms) trace=%s "
            "node=%d table=%s stats=[%s]", what, elapsed_ms, thr,
            sp["trace_id"], self.datanode.opts.node_id,
            cmd.get("table"), stats.summary())

    # ---- read plane ----
    def do_get(self, context, ticket):
        cmd = json.loads(ticket.ticket)
        kind = cmd.get("type")
        if kind not in ("scan", "region_moments"):
            raise GreptimeError(f"unsupported ticket {kind!r}")
        _apply_wire_verdicts(cmd)
        # the scan executes eagerly under a local collector; its stats
        # ride the stream schema back so the frontend can render this
        # node's stage rows in its EXPLAIN ANALYZE tree
        stats = exec_stats.ExecStats()
        t0 = time.perf_counter()
        with remote_context(cmd.get("traceparent")), \
                span(f"dn_{kind}", node=self.datanode.opts.node_id,
                     table=cmd.get("table")) as sp, \
                exec_stats.collect(stats):
            if kind == "scan":
                batches, fallback = self._do_scan(cmd)
            else:
                frames = self._do_region_moments(cmd)
        self._log_slow(sp, kind, cmd, (time.perf_counter() - t0) * 1e3,
                       stats)
        metadata = {EXEC_STATS_KEY: json.dumps(stats.to_dict()).encode()}
        exported = _export_spans()
        if exported:
            from ..common.trace_store import TRACE_SPANS_WIRE_KEY
            metadata[TRACE_SPANS_WIRE_KEY] = \
                json.dumps(exported).encode()
        if kind == "scan":
            return _batches_stream(batches, fallback, metadata=metadata)
        return _frames_stream(frames, metadata=metadata)

    def _do_scan(self, cmd):
        from ..common.time import TimestampRange
        from ..query.plan_codec import expr_from_dict
        filters = [expr_from_dict(f) for f in cmd["filters"]] \
            if cmd.get("filters") else None
        # rebuild a real TimestampRange: Region.scan dereferences
        # .start/.end, so the wire's [lo, hi] pair must not stay a
        # tuple (ranges ship in ms, the region-native unit)
        time_range = None
        if cmd.get("time_range"):
            lo, hi = cmd["time_range"]
            time_range = TimestampRange(lo, hi)
        # self.local (a LocalDatanodeClient) records the "scan" stage
        batches = self.local.scan_batches(
            cmd["catalog"], cmd["schema"], cmd["table"],
            projection=cmd.get("projection"),
            time_range=time_range,
            limit=cmd.get("limit"), filters=filters,
            regions=cmd.get("regions"))
        t = self.datanode.catalog.table(
            cmd["catalog"], cmd["schema"], cmd["table"])
        fallback = None
        if t is not None:
            fallback = t.schema if cmd.get("projection") is None \
                else t.schema.project(cmd["projection"])
        return batches, fallback

    def _do_region_moments(self, cmd):
        from ..query.plan_codec import plan_from_dict
        return self.local.region_moments(
            cmd["catalog"], cmd["schema"], cmd["table"],
            plan_from_dict(cmd["plan"]), regions=cmd.get("regions"))


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
        self._serving = t
        return t

    def shutdown(self) -> None:
        """Shut down, then wait for the serve thread to return: a Flight
        server whose serve() is still winding down can close the
        listening socket of a server made after it in the same process
        (pyarrow 25)."""
        super().shutdown()
        t = getattr(self, "_serving", None)
        if t is not None and t is not threading.current_thread():
            t.join()

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
