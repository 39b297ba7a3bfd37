"""Flight clients: the wire twins of the in-process data-plane clients.

Reference behavior: src/client/src/database.rs:39,209-260 — `Database`
sends inserts over gRPC and ships queries whose results stream back over
Arrow Flight `do_get`. Two clients here:

- `FlightDatanodeClient` implements the `DatanodeClient` surface over a
  `FlightDatanodeServer`, a drop-in for `LocalDatanodeClient` across
  real sockets;
- `Database` is the user-facing client against a `FlightFrontendServer`:
  `sql()`, auto-create `insert()` and `bulk_load()` — the README
  quick-start surface.

Ported from greptimedb_tpu/client/flight.py; its tickets and descriptors
are byte-identical to the reference's (a `region_moments` ticket carries
the plan as `query/plan_codec.py` encodes it), so either package's client
talks to either's server. It imports no torch: a client process starts
without the CUDA libraries (`describe_table` decodes the partition rule
through mito's codec, an engine import inside the method).
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.flight as flight

from ..common import exec_stats
from ..common.telemetry import current_traceparent
from ..datatypes.record_batch import RecordBatch
from ..errors import GreptimeError, TableNotFoundError
from ..table.metadata import TableInfo
from ..table.requests import CreateTableRequest, create_request_to_dict
from . import DatanodeClient

if TYPE_CHECKING:
    import pandas as pd


def _traced(body: dict) -> dict:
    """Attach the caller's W3C trace context so the server joins this
    trace (servers pop the key before dispatching) — plus, from a
    verdict-deciding (root) trace sink, the recent tail-sampling
    verdicts: datanodes buffer spans blind, and the verdicts piggyback
    on whatever RPC happens next (released spans ride its response)."""
    from ..common import trace_store
    tp = current_traceparent()
    out = {**body, "traceparent": tp} if tp is not None else body
    sink = trace_store.sink()
    if sink is not None and sink.role == "root":
        verdicts = sink.recent_verdicts()
        if verdicts:
            out = dict(out)
            out[trace_store.TRACE_VERDICTS_BODY_KEY] = verdicts
    return out


def _absorb_wire_spans(rows) -> None:
    """Buffered datanode spans released by a piggybacked verdict: queue
    them on the local (root) sink for the next trace-store flush."""
    if not rows:
        return
    from ..common import trace_store
    sink = trace_store.sink()
    if sink is not None and isinstance(rows, list):
        sink.absorb_spans(rows)


def _absorb_stream_stats(schema: pa.Schema) -> None:
    """Replay datanode-side ExecStats riding the stream schema into the
    active collector (the per-RPC node sub-collector during a scatter),
    and absorb any trace spans the datanode's sink released."""
    meta = schema.metadata or {}
    raw = meta.get(exec_stats.EXEC_STATS_WIRE_KEY)
    if raw:
        try:
            exec_stats.absorb_remote(json.loads(raw))
        except (ValueError, TypeError, KeyError):
            pass             # stats are advisory; never fail a read
    from ..common import trace_store
    raw_spans = meta.get(trace_store.TRACE_SPANS_WIRE_KEY)
    if raw_spans:
        try:
            _absorb_wire_spans(json.loads(raw_spans))
        except (ValueError, TypeError):
            pass             # spans are advisory too


def _columns_to_arrow(columns: Dict[str, Sequence]) -> pa.Table:
    # a numpy column converts in one call; anything else goes through a
    # list, as the reference converts every column (same arrow types for
    # bool, integer, float64 and object columns)
    return pa.table({k: v if isinstance(v, np.ndarray) else list(v)
                     for k, v in columns.items()})


def _to_greptime_error(e: flight.FlightError) -> GreptimeError:
    """Server-side GreptimeErrors cross the wire as gRPC status messages;
    rebuild the closest taxonomy member so callers keep one except path.
    Unavailable/timeout faults map to TransientRpcError so the
    distributed fan-out's retry loop recognizes real network hops; the
    'stale route' marker maps to StaleRouteError so the DistTable's
    route-refresh retry works across real sockets too."""
    from ..errors import OverloadedError, StaleRouteError, TransientRpcError
    msg = str(e).split(". gRPC client debug context:")[0]
    if isinstance(e, (flight.FlightUnavailableError,
                      flight.FlightTimedOutError)):
        return TransientRpcError(msg)
    if StaleRouteError.WIRE_MARKER in msg:
        return StaleRouteError(msg)
    if OverloadedError.WIRE_MARKER in msg:
        # admission rejection crossing the wire: keep the type so a
        # routing frontend re-maps it to 429/server-busy, not 500
        return OverloadedError(msg)
    from ..query.plan_codec import WIRE_UNSUPPORTED_MARKER
    if WIRE_UNSUPPORTED_MARKER in msg:
        # version-skewed plan rejected by an older datanode: keep the
        # type so the frontend degrades the statement to the raw path
        from ..errors import UnsupportedError
        return UnsupportedError(msg)
    if "not found" in msg or "not on datanode" in msg:
        return TableNotFoundError(msg)
    return GreptimeError(msg)


class _FlightBase:
    def __init__(self, address: str):
        self.address = address
        self._conn: Optional[flight.FlightClient] = None

    @property
    def conn(self) -> flight.FlightClient:
        if self._conn is None:
            self._conn = flight.FlightClient(self.address)
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _action(self, kind: str, body: dict) -> dict:
        try:
            results = list(self.conn.do_action(
                flight.Action(kind, json.dumps(_traced(body)).encode())))
            resp = json.loads(results[0].body.to_pybytes())
        except flight.FlightError as e:
            raise _to_greptime_error(e) from None
        _absorb_wire_spans(resp.pop("trace_spans", None))
        if not resp.get("ok", False):
            err = resp.get("error", "unknown flight error")
            if resp.get("error_type") == "TableNotFoundError":
                raise TableNotFoundError(err)
            if resp.get("error_type") == "StaleRouteError":
                from ..errors import StaleRouteError
                raise StaleRouteError(err)
            if resp.get("error_type") == "OverloadedError":
                from ..errors import OverloadedError
                raise OverloadedError(err)
            raise GreptimeError(err)
        return resp

    def _put(self, command: dict, data: pa.Table) -> int:
        descriptor = flight.FlightDescriptor.for_command(
            json.dumps(_traced(command)).encode())
        try:
            writer, reader = self.conn.do_put(descriptor, data.schema)
            with writer:
                writer.write_table(data)
                writer.done_writing()
                buf = reader.read()
        except flight.FlightError as e:
            raise _to_greptime_error(e) from None
        meta = json.loads(buf.to_pybytes()) if buf is not None else {}
        _absorb_wire_spans(meta.pop("trace_spans", None))
        if meta.get("exec_stats"):
            try:
                exec_stats.absorb_remote(meta["exec_stats"])
            except (ValueError, TypeError, KeyError):
                pass         # advisory: a write that landed must not fail
        return int(meta.get("affected_rows", 0))


class FlightDatanodeClient(_FlightBase, DatanodeClient):
    """DatanodeClient over Arrow Flight — the multi-host router↔worker
    transport (a drop-in for LocalDatanodeClient)."""

    def __init__(self, address: str, node_id: int):
        super().__init__(address)
        self.node_id = node_id

    def ddl_create_table(self, request: CreateTableRequest) -> None:
        self._action("ddl_create_table",
                     {"request": create_request_to_dict(request)})

    def ddl_alter_table(self, request) -> None:
        from ..table.requests import alter_request_to_dict
        self._action("ddl_alter_table",
                     {"request": alter_request_to_dict(request)})

    def ddl_drop_table(self, catalog: str, schema: str, name: str) -> bool:
        return bool(self._action("ddl_drop_table", {
            "catalog": catalog, "schema": schema, "table": name})["dropped"])

    def write_region(self, catalog: str, schema: str, table: str,
                     region_number: int, columns: Dict[str, Sequence],
                     op: str = "put") -> int:
        return self._put(
            {"type": "write_region", "catalog": catalog, "schema": schema,
             "table": table, "region_number": region_number, "op": op},
            _columns_to_arrow(columns))

    def region_moments(self, catalog: str, schema: str, table: str,
                       plan, regions=None) -> List[pd.DataFrame]:
        from ..query.plan_codec import plan_to_dict
        ticket = flight.Ticket(json.dumps(_traced(
            {"type": "region_moments", "catalog": catalog,
             "schema": schema, "table": table,
             "plan": plan_to_dict(plan),
             "regions": list(regions) if regions is not None
             else None})).encode())
        frames = []
        wire_bytes = 0
        try:
            reader = self.conn.do_get(ticket)
            while True:
                try:
                    chunk = reader.read_chunk()
                except StopIteration:
                    break
                if chunk.data is not None:
                    wire_bytes += chunk.data.nbytes
                    frames.append(chunk.data.to_pandas())
            _absorb_stream_stats(reader.schema)
        except flight.FlightError as e:
            raise _to_greptime_error(e) from None
        # actual serialized partial-frame bytes off THIS hop — lands on
        # the per-RPC node sub-collector so the EXPLAIN ANALYZE node
        # block shows what the wire carried instead of raw rows
        exec_stats.record("partial_wire", bytes=wire_bytes,
                          frames=len(frames))
        return [f for f in frames if len(f)]

    def scan_batches(self, catalog: str, schema: str, table: str,
                     projection: Optional[Sequence[str]] = None,
                     time_range=None, limit: Optional[int] = None,
                     filters: Optional[Sequence] = None,
                     regions: Optional[Sequence[int]] = None) -> list:
        from ..query.plan_codec import expr_to_dict
        if time_range is not None and hasattr(time_range, "start"):
            time_range = (time_range.start, time_range.end)
        ticket = flight.Ticket(json.dumps(_traced(
            {"type": "scan", "catalog": catalog, "schema": schema,
             "table": table, "projection": list(projection)
             if projection is not None else None,
             "time_range": list(time_range)
             if time_range is not None else None,
             "limit": limit,
             "filters": [expr_to_dict(f) for f in filters]
             if filters else None,
             "regions": list(regions)
             if regions is not None else None})).encode())
        out = []
        try:
            reader = self.conn.do_get(ticket)
            while True:
                try:
                    chunk = reader.read_chunk()
                except StopIteration:
                    break
                if chunk.data is not None:
                    out.append(RecordBatch.from_arrow(chunk.data))
            _absorb_stream_stats(reader.schema)
        except flight.FlightError as e:
            raise _to_greptime_error(e) from None
        return out

    def flush_table(self, catalog: str, schema: str, table: str) -> None:
        self._action("flush_table", {"catalog": catalog, "schema": schema,
                                     "table": table})

    def describe_table(self, catalog: str, schema: str, name: str):
        resp = self._action("describe_table", {
            "catalog": catalog, "schema": schema, "table": name})
        if resp.get("info") is None:
            return None
        from ..mito.engine import _deserialize_rule
        info = TableInfo.from_dict(resp["info"])
        return info, _deserialize_rule(info.meta.partition_rule)

    def ping(self) -> int:
        return int(self._action("ping", {})["node_id"])

    def repl_apply(self, catalog: str, schema: str, table: str,
                   region_number: int, entries: list,
                   leader_flushed: int = 0) -> dict:
        """Ship WAL records to this node's standby replica of the region
        (leader shipper → follower, the continuous replication hop)."""
        return self._action("repl_apply", {
            "catalog": catalog, "schema": schema, "table": table,
            "region_number": int(region_number), "entries": entries,
            "leader_flushed": int(leader_flushed)})

    def background_jobs(self) -> list:
        """This datanode's live + recent background jobs (the
        cluster-merged information_schema.background_jobs view)."""
        return list(self._action("background_jobs", {}).get("jobs", []))

    def profile(self, *, seconds=None, hz=None, drain: bool = False
                ) -> list:
        """This datanode's profiler rows: a timed high-rate burst
        (`seconds`/`hz`) or a drain of its pending sample aggregate —
        either way the frontend absorbs the rows and owns the flush."""
        body: dict = {}
        if seconds is not None:
            body["seconds"] = float(seconds)
            if hz is not None:
                body["hz"] = float(hz)
        elif drain:
            body["drain"] = True
        return list(self._action("profile", body).get("rows", []))


class Database(_FlightBase):
    """User-facing client (reference `Database`, client/src/database.rs)."""

    def sql(self, sql: str):
        """Run SQL; returns list[RecordBatch] for queries, int affected
        rows for DML/DDL."""
        ticket = flight.Ticket(json.dumps(_traced(
            {"type": "sql", "sql": sql})).encode())
        try:
            reader = self.conn.do_get(ticket)
            table = reader.read_all()
        except flight.FlightError as e:
            raise _to_greptime_error(e) from None
        meta = table.schema.metadata or {}
        if meta.get(b"gdb.kind") == b"affected_rows":
            return int(table.column(0)[0].as_py()) if table.num_rows else 0
        return [RecordBatch.from_arrow(b)
                for b in table.combine_chunks().to_batches()]

    def insert(self, table: str, columns: Dict[str, Sequence],
               tag_columns: Sequence[str] = (),
               timestamp_column: str = "greptime_timestamp") -> int:
        """gRPC-style row insert with auto table create / alter."""
        return self._put(
            {"type": "row_insert", "table": table,
             "tag_columns": list(tag_columns),
             "timestamp_column": timestamp_column},
            _columns_to_arrow(columns))

    def bulk_load(self, table: str, columns: Dict[str, Sequence],
                  tag_columns: Sequence[str] = (),
                  timestamp_column: str = "greptime_timestamp") -> int:
        """WAL-less bulk load (loader path): rows go straight to sorted
        SSTs server-side, skipping the WAL+memtable write path — same
        auto create/alter as insert(), ~an order of magnitude faster for
        large batches."""
        return self._put(
            {"type": "bulk_load", "table": table,
             "tag_columns": list(tag_columns),
             "timestamp_column": timestamp_column},
            _columns_to_arrow(columns))
