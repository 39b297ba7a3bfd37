"""Datanode instance: storage + table engines + catalog + query engine.

Reference behavior: src/datanode/src/instance.rs — `Instance::new_with`
builds object store → log store → storage engine → mito engine → catalog →
query engine; `start_instance` replays the catalog (which replays region
WALs via table open).

Ported from greptimedb_tpu/datanode/instance.py. The query engine and
the flow folds run on `DatanodeOptions.device` ("cuda" unless the caller
asks for "cpu"); flow specs and watermarks persist on the object store
and are reloaded at start. `engines` holds mito and the immutable
file-table engine (file_table/, CREATE EXTERNAL TABLE).

As a cluster member a datanode has a `node_id`: a non-zero id scopes its
WAL (`nodes/<id>/wal` under the data home) and its control state (mito's
registry and manifests, the catalog document, procedures, external
tables and flows under `nodes/<id>/` in the object store), so datanodes
that share one object store keep their own; region data stays globally
addressed. Node 0 keeps the standalone layout. `start_heartbeat` reports
liveness and region stats to the meta service (meta/) and runs the
mailbox messages that ride its responses.

Not ported yet: read-replica shipping and the balancer's region steps
(failover adoption, migrate, split, standbys), which need mito's
distributed methods and datanode/replication.py (ROADMAP Queue 1, h4).
Each of them raises an UnsupportedError that names h4; a balancer step's
failure is acked to meta as the reference acks any failed step.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from .. import DEFAULT_CATALOG_NAME, DEFAULT_SCHEMA_NAME
from ..catalog import LocalCatalogManager
from ..errors import UnsupportedError
from ..file_table import ImmutableFileTableEngine
from ..flow import FlowManager, ObjectStoreFlowStore
from ..mito import MitoEngine
from ..mito.procedure import register_loaders
from ..procedure import ProcedureManager
from ..query import QueryEngine
from ..storage.engine import EngineConfig, StorageEngine
from ..storage.object_store import ObjectStore
from ..table import NumbersTable
from ..table.requests import CreateTableRequest

logger = logging.getLogger(__name__)

#: live in-process datanodes by node id (latest wins), as in the
#: reference: same-process peers resolve each other here instead of
#: dialing a Flight socket (single-process clusters: tests, embedded
#: topologies)
_live_lock = threading.Lock()
_live_datanodes: Dict[int, "DatanodeInstance"] = {}


def live_datanode(node_id) -> Optional["DatanodeInstance"]:
    if node_id is None:
        return None
    with _live_lock:
        return _live_datanodes.get(int(node_id))


def _needs_h4(what: str) -> UnsupportedError:
    return UnsupportedError(
        f"{what} needs mito's region adoption / standby / split methods "
        f"and read-replica shipping, which the port has not yet (ROADMAP "
        f"Queue 1, h4)")


@dataclass
class DatanodeOptions:
    data_home: str = "./greptimedb_data"
    node_id: int = 0
    flush_size_bytes: int = 64 * 1024 * 1024
    wal_sync_on_write: bool = False
    disable_wal: bool = False
    register_numbers_table: bool = True   # test fixture, like the reference
    #: continuous-flow background fold cadence; the free-running task is
    #: never started under pytest (tests drive FlowManager.tick()
    #: cooperatively — tier-1 safety), and 0 disables it everywhere
    flow_tick_interval_s: float = 10.0
    #: self-monitoring scrape cadence (metrics + region heat →
    #: greptime_private system tables); same pytest/0 rules as the flow
    #: tick
    self_monitor_interval_s: float = 30.0
    #: where the query engine and the flow folds run; tests pass "cpu"
    device: str = "cuda"


class DatanodeInstance:
    def __init__(self, opts: DatanodeOptions,
                 store: Optional[ObjectStore] = None):
        self.opts = opts
        if torch.device(opts.device).type == "cuda" and \
                not torch.cuda.is_available():
            # no CPU fallback: a caller who wants the CPU asks for it
            raise RuntimeError(
                f"CUDA is not available: the datanode's query engine runs "
                f"on {opts.device!r} (pass device='cpu' to run on the CPU)")
        config = EngineConfig(
            data_home=opts.data_home,
            # node-scoped WAL home: datanodes that share one data_home
            # must never share WAL dirs or region fence markers
            wal_home=os.path.join(opts.data_home, "nodes",
                                  str(opts.node_id), "wal")
            if opts.node_id else None,
            flush_size_bytes=opts.flush_size_bytes,
            wal_sync_on_write=opts.wal_sync_on_write,
            disable_wal=opts.disable_wal)
        self.storage = StorageEngine(config, store=store)
        self.store = self.storage.store
        # node-scoped control state: on a shared object store each
        # datanode keeps its own registry/manifests/catalog doc while
        # region data stays globally addressed
        prefix = f"nodes/{opts.node_id}/" if opts.node_id else ""
        self.state_prefix = prefix
        self.mito = MitoEngine(self.storage, state_prefix=prefix)
        self.file_engine = ImmutableFileTableEngine(self.store,
                                                    state_prefix=prefix)
        self.engines = {self.mito.name: self.mito,
                        self.file_engine.name: self.file_engine}
        self.catalog = LocalCatalogManager(self.store, self.engines,
                                           state_prefix=prefix)
        self.query_engine = QueryEngine(self.catalog, device=opts.device)
        # durable DDL (reference: procedure manager + loader registration,
        # src/datanode/src/instance.rs:210-236)
        self.procedure_manager = ProcedureManager(self.store,
                                                  state_prefix=prefix)
        register_loaders(self.procedure_manager, self.mito, self.catalog)
        # continuous rollup flows: specs + watermarks persist next to the
        # mito manifests; the query engine gets the manager for the
        # transparent rollup rewrite
        self.flow_manager = FlowManager(
            self.catalog, ObjectStoreFlowStore(self.store, prefix),
            create_sink_fn=self._create_flow_sink, device=opts.device)
        self.query_engine.flow_manager = self.flow_manager
        # information_schema gauges read flow watermarks off the catalog
        self.catalog.flow_manager = self.flow_manager
        self._started = False
        self._heartbeat_task = None
        #: meta client for datanode→meta control RPCs (balancer step
        #: acks); start_heartbeat wires it, tests may attach directly
        self._meta_client = None
        with _live_lock:
            _live_datanodes[int(opts.node_id)] = self

    def _create_flow_sink(self, spec, schema, pk_indices):
        table = self.mito.create_table(CreateTableRequest(
            spec.sink, schema, catalog_name=spec.catalog,
            schema_name=spec.schema, primary_key_indices=pk_indices,
            create_if_not_exists=True))
        if self.catalog.table(spec.catalog, spec.schema, spec.sink) is None:
            self.catalog.register_table(spec.catalog, spec.schema,
                                        spec.sink, table)
        return table

    def start(self) -> None:
        """Catalog replay → table open → region WAL replay → resume
        in-flight procedures → reload flow specs + watermarks."""
        self.catalog.start()
        self.procedure_manager.recover()
        self.flow_manager.recover()
        if self.opts.flow_tick_interval_s > 0 and \
                "PYTEST_CURRENT_TEST" not in os.environ:
            self.flow_manager.start_background(
                self.opts.flow_tick_interval_s)
        if self.opts.register_numbers_table and \
                self.catalog.table(DEFAULT_CATALOG_NAME, DEFAULT_SCHEMA_NAME,
                                   "numbers") is None:
            self.catalog.register_table(
                DEFAULT_CATALOG_NAME, DEFAULT_SCHEMA_NAME, "numbers",
                NumbersTable())
        self._started = True

    def attach_meta(self, meta_client) -> None:
        """Wire the meta client used for balancer step acks (heartbeat
        startup calls this; cooperative tests call it directly)."""
        self._meta_client = meta_client

    def start_heartbeat(self, meta_client, interval_s: float = 5.0,
                        stats_every: int = 4) -> None:
        """Report liveness + region stats to the meta service (reference:
        src/datanode/src/heartbeat.rs:27-141; stats feed the load-based
        selector and the phi failure detector). Liveness beats every
        `interval_s`; the per-region stat walk (O(regions × files) over
        memtable/SST metadata) rides only every `stats_every`-th beat —
        meta derives ingest rates from the elapsed time between stat
        beats, so the lower cadence doesn't distort them. The first beat
        runs here, before the repeating task starts: it registers the
        node."""
        from ..common.telemetry import root_span
        from ..meta import DatanodeStat
        from ..query.stream_exec import region_stat_entries
        from ..storage.scheduler import RepeatedTask
        self.attach_meta(meta_client)
        counter = [0]

        def beat():
            regions = self.storage.list_regions()
            if counter[0] % max(1, stats_every) == 0:
                region_stats, total_rows, total_bytes = \
                    region_stat_entries(regions.values())
                stat = DatanodeStat(region_count=len(regions),
                                    approximate_rows=total_rows,
                                    approximate_bytes=total_bytes,
                                    region_stats=region_stats)
            else:
                # light beat: region_count only; the per-region walk
                # waits for the next full beat
                stat = DatanodeStat(region_count=len(regions),
                                    full=False)
            counter[0] += 1
            # each beat is its own (sampled) trace: the loop thread has
            # no ambient context to inherit
            with root_span("heartbeat", node=self.opts.node_id):
                resp = meta_client.heartbeat(self.opts.node_id, stat)
            for msg in resp.mailbox:
                self._handle_mailbox(msg)

        beat()
        self._heartbeat_task = RepeatedTask(
            interval_s, beat, name=f"heartbeat-dn{self.opts.node_id}")
        self._heartbeat_task.start()

    def _handle_mailbox(self, msg: dict) -> None:
        """Meta→datanode control messages riding heartbeat responses."""
        kind = msg.get("type")
        if kind == "flush_table":
            t = self.catalog.table(msg["catalog"], msg["schema"],
                                   msg["table"])
            if t is not None:
                t.flush()
        elif kind == "open_regions":
            # failover adoption of a dead peer's regions: logged, as the
            # reference logs an adoption it cannot run
            logger.error("open_regions for %s regions %s: %s",
                         msg.get("table"), msg.get("region_numbers"),
                         _needs_h4("failover adoption (open_regions)"))
        elif kind is not None and (kind.startswith("balancer_") or
                                   kind.startswith("repl_")):
            self._handle_balancer_msg(msg)

    # ---- elastic-region steps (meta/balancer.py's worker side) ----
    def _handle_balancer_msg(self, msg: dict) -> None:
        """Run one balancer step and ack the result to meta; a failed
        step is acked with its error, and the balancer rolls back."""
        op_id, step = msg.get("op_id"), msg.get("type")
        from ..common import background_jobs
        try:
            with background_jobs.job(
                    "balancer_step", table=msg.get("table"),
                    region=str(msg.get("region")), op_id=op_id,
                    step=step):
                payload = self._balancer_step(msg)
            ok, error = True, None
        except Exception as e:  # noqa: BLE001 — relayed to the balancer,
            # which rolls the operation back or retries the step
            logger.exception("balancer step %s of op %s failed",
                             step, op_id)
            ok, error, payload = False, f"{type(e).__name__}: {e}", {}
        if op_id is None:
            # fire-and-forget control message (failover promotion /
            # follower re-wiring): no op doc is waiting on an ack
            return
        if self._meta_client is None:
            logger.error("balancer step %s of op %s has no meta client "
                         "to ack through", step, op_id)
            return
        try:
            self._meta_client.balancer_ack(
                self.opts.node_id, op_id, step, ok, error, payload or {})
        except Exception:  # noqa: BLE001 — the balancer re-mails the
            logger.exception(          # step after its ack timeout
                "balancer ack for op %s step %s failed", op_id, step)

    def _balancer_step(self, msg: dict) -> dict:
        raise _needs_h4(f"balancer step {msg['type']!r}")

    def repl_apply(self, catalog: str, schema: str, table: str,
                   region_number: int, entries: list,
                   leader_flushed: int = 0) -> dict:
        """Apply shipped WAL records to a standby replica of the region
        (the follower side of continuous replication)."""
        raise _needs_h4(f"repl_apply to region {region_number} of "
                        f"{catalog}.{schema}.{table}")

    def shutdown(self) -> None:
        self.flow_manager.stop()
        if self._heartbeat_task is not None:
            self._heartbeat_task.stop()
        for engine in self.engines.values():
            engine.close()
        self.storage.close()
        with _live_lock:
            if _live_datanodes.get(int(self.opts.node_id)) is self:
                del _live_datanodes[int(self.opts.node_id)]
