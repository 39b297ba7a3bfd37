"""Datanode instance: storage + table engines + catalog + query engine.

Reference behavior: src/datanode/src/instance.rs — `Instance::new_with`
builds object store → log store → storage engine → mito engine → catalog →
query engine; `start_instance` replays the catalog (which replays region
WALs via table open).

Ported from greptimedb_tpu/datanode/instance.py for the standalone
deployment. The query engine and the flow folds run on
`DatanodeOptions.device` ("cuda" unless the caller asks for "cpu"); flow
specs and watermarks persist on the object store and are reloaded at
start. `engines` holds mito and the immutable file-table engine
(file_table/, CREATE EXTERNAL TABLE). Not ported yet: read-replica
shipping, the heartbeat and the balancer's mailbox
steps, with the node id that scopes a datanode's WAL and control state
on a shared object store.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

from .. import DEFAULT_CATALOG_NAME, DEFAULT_SCHEMA_NAME
from ..catalog import LocalCatalogManager
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


@dataclass
class DatanodeOptions:
    data_home: str = "./greptimedb_data"
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
            flush_size_bytes=opts.flush_size_bytes,
            wal_sync_on_write=opts.wal_sync_on_write,
            disable_wal=opts.disable_wal)
        self.storage = StorageEngine(config, store=store)
        self.store = self.storage.store
        self.mito = MitoEngine(self.storage)
        self.file_engine = ImmutableFileTableEngine(self.store)
        self.engines = {self.mito.name: self.mito,
                        self.file_engine.name: self.file_engine}
        self.catalog = LocalCatalogManager(self.store, self.engines)
        self.query_engine = QueryEngine(self.catalog, device=opts.device)
        # durable DDL (reference: procedure manager + loader registration,
        # src/datanode/src/instance.rs:210-236)
        self.procedure_manager = ProcedureManager(self.store)
        register_loaders(self.procedure_manager, self.mito, self.catalog)
        # continuous rollup flows: specs + watermarks persist next to the
        # mito manifests; the query engine gets the manager for the
        # transparent rollup rewrite
        self.flow_manager = FlowManager(
            self.catalog, ObjectStoreFlowStore(self.store),
            create_sink_fn=self._create_flow_sink, device=opts.device)
        self.query_engine.flow_manager = self.flow_manager
        # information_schema gauges read flow watermarks off the catalog
        self.catalog.flow_manager = self.flow_manager
        self._started = False

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

    def shutdown(self) -> None:
        self.flow_manager.stop()
        for engine in self.engines.values():
            engine.close()
        self.storage.close()
