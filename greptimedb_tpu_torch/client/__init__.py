"""Clients of a GreptimeDB server, and the router↔worker data plane.

Reference behavior: src/client — `Database` sends inserts and ships
queries whose results stream back over Arrow Flight
(database.rs:39,209-260); per-region inserts and shipped plans reach
datanodes the same way. The datanode surface (`DatanodeClient`) has two
implementations:

- `LocalDatanodeClient`: direct in-process calls (the reference's
  MockDistributedInstance topology, frontend/src/tests.rs:60) — also the
  fast path when router and worker share a host;
- `FlightDatanodeClient` (client/flight.py): the identical surface over
  sockets, against a `FlightDatanodeServer` (servers/flight.py).

`region_moments` pushes the aggregation moments down: each worker
reduces its regions with the segment-moments kernel on its device and
returns per-run moment frames that the frontend folds.

Ported from greptimedb_tpu/client/. This module and client/flight.py
import no torch (a client process runs them); the engine imports stay
inside the methods that run on a datanode, as in the reference.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from ..table.requests import CreateTableRequest, DropTableRequest

if TYPE_CHECKING:
    import pandas as pd


class DatanodeClient:
    """Abstract data-plane client for one datanode."""

    def ddl_create_table(self, request: CreateTableRequest) -> None:
        raise NotImplementedError

    def ddl_drop_table(self, catalog: str, schema: str, name: str) -> bool:
        raise NotImplementedError

    def ddl_alter_table(self, request) -> None:
        raise NotImplementedError

    def write_region(self, catalog: str, schema: str, table: str,
                     region_number: int, columns: Dict[str, Sequence],
                     op: str = "put") -> int:
        raise NotImplementedError

    def region_moments(self, catalog: str, schema: str, table: str,
                       plan, regions: Optional[Sequence[int]] = None
                       ) -> List[pd.DataFrame]:
        """Run the aggregate plan over this node's regions of the table
        (restricted to `regions` when the frontend pruned); returns
        per-region moment frames for the frontend fold."""
        raise NotImplementedError

    def scan_batches(self, catalog: str, schema: str, table: str,
                     projection: Optional[Sequence[str]] = None,
                     time_range=None, limit: Optional[int] = None,
                     filters: Optional[Sequence] = None,
                     regions: Optional[Sequence[int]] = None) -> list:
        raise NotImplementedError

    def flush_table(self, catalog: str, schema: str, table: str) -> None:
        raise NotImplementedError

    def describe_table(self, catalog: str, schema: str, name: str):
        """(TableInfo, partition_rule) of a hosted table, or None."""
        raise NotImplementedError


class LocalDatanodeClient(DatanodeClient):
    def __init__(self, datanode):
        self.datanode = datanode

    @property
    def node_id(self) -> int:
        return self.datanode.opts.node_id

    def _table(self, catalog: str, schema: str, name: str):
        from ..errors import TableNotFoundError
        t = self.datanode.catalog.table(catalog, schema, name)
        if t is None:
            raise TableNotFoundError(f"table {catalog}.{schema}.{name} "
                                     f"not on datanode {self.node_id}")
        return t

    def ddl_create_table(self, request: CreateTableRequest) -> None:
        table = self.datanode.mito.create_table(request)
        cat = self.datanode.catalog
        if cat.table(request.catalog_name, request.schema_name,
                     request.table_name) is None:
            cat.register_table(request.catalog_name, request.schema_name,
                               request.table_name, table)

    def ddl_drop_table(self, catalog: str, schema: str, name: str) -> bool:
        ok = self.datanode.mito.drop_table(
            DropTableRequest(name, catalog, schema))
        self.datanode.catalog.deregister_table(catalog, schema, name)
        return ok

    def ddl_alter_table(self, request) -> None:
        table = self.datanode.mito.alter_table(request)
        cat = self.datanode.catalog
        cat.deregister_table(request.catalog_name, request.schema_name,
                             request.table_name)
        cat.register_table(request.catalog_name, request.schema_name,
                           request.new_table_name or request.table_name,
                           table)

    def _node_ctx(self):
        # in-process cluster: datanode work runs on the caller's own
        # threads, so the sampler needs the per-node label pushed here
        # (a no-op context while nothing samples)
        from ..common import profiler
        return profiler.node_context(f"dn{self.node_id}")

    def write_region(self, catalog: str, schema: str, table: str,
                     region_number: int, columns: Dict[str, Sequence],
                     op: str = "put") -> int:
        with self._node_ctx():
            return self._table(catalog, schema, table).write_region(
                region_number, columns, op)

    def region_moments(self, catalog: str, schema: str, table: str,
                       plan, regions: Optional[Sequence[int]] = None
                       ) -> List[pd.DataFrame]:
        from ..query.tpu_exec import region_moment_frames
        with self._node_ctx():
            return region_moment_frames(
                self._table(catalog, schema, table), plan,
                self.datanode.query_engine.device, regions=regions)

    def scan_batches(self, catalog: str, schema: str, table: str,
                     projection: Optional[Sequence[str]] = None,
                     time_range=None, limit: Optional[int] = None,
                     filters: Optional[Sequence] = None,
                     regions: Optional[Sequence[int]] = None) -> list:
        from ..common import exec_stats
        with self._node_ctx(), exec_stats.stage("scan"):
            batches = self._table(catalog, schema, table).scan_batches(
                projection=projection, time_range=time_range, limit=limit,
                filters=filters, regions=regions)
        # same stage name the Flight datanode server records, so the
        # per-node EXPLAIN ANALYZE tree is identical on both transports
        exec_stats.record("scan", rows=sum(b.num_rows for b in batches))
        return batches

    def flush_table(self, catalog: str, schema: str, table: str) -> None:
        with self._node_ctx():
            self._table(catalog, schema, table).flush()

    def describe_table(self, catalog: str, schema: str, name: str):
        t = self.datanode.catalog.table(catalog, schema, name)
        if t is None:
            return None
        return t.info, getattr(t, "partition_rule", None)

    def ping(self) -> int:
        return self.node_id

    def repl_apply(self, catalog: str, schema: str, table: str,
                   region_number: int, entries: list,
                   leader_flushed: int = 0) -> dict:
        """Apply shipped WAL records to this node's standby replica of
        the region (the continuous-replication consumer side)."""
        with self._node_ctx():
            return self.datanode.repl_apply(
                catalog, schema, table, region_number, entries,
                leader_flushed=leader_flushed)

    def background_jobs(self) -> list:
        """In-process twin of the Flight action. The registry is
        process-wide, so for an in-process cluster these rows duplicate
        the caller's own — the view dedups by (node, job_id)."""
        from ..common import background_jobs
        return background_jobs.rows()

    def profile(self, *, seconds: Optional[float] = None,
                hz: Optional[float] = None, drain: bool = False) -> list:
        """In-process twin of the Flight `profile` action. The sampler
        is process-wide (the caller's own), so draining or bursting here
        would double-count it — per-node attribution instead rides the
        `node_context` pushed around the data-plane calls above."""
        return []
