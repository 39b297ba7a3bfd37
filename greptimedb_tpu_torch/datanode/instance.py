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

A datanode mailed `open_regions` by meta's failover runner adopts a
dead peer's regions from the shared object store (mito's
`adopt_regions`) and registers the table if it is new. The balancer
(meta/balancer.py) drives the elastic region operations (migrate, split,
read replicas) through mailbox messages riding heartbeat responses; each
handler here performs one idempotent step (flush snapshot, fence +
WAL-tail read, adopt + tail replay, release, split copy/apply, standby
attach and promotion) and reports back through ``balancer_ack`` on the
meta client, so a re-delivered message after a crash resumes the
operation instead of corrupting it. `ReplicaShipper`
(datanode/replication.py) ships each leader region's WAL tail to its
followers' `repl_apply`.
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
from ..common import failpoint as _fp
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

_fp.register("balancer_snapshot_upload")
_fp.register("repl_apply")
_fp.register("repl_promote")
_fp.register("repl_bootstrap")

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
        # continuous WAL-tail replication to read replicas:
        # repl_set_followers mailbox steps wire regions in, the region
        # on_commit hook nudges the ship thread
        from .replication import ReplicaShipper
        self.replication = ReplicaShipper(self)
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
            # failover: adopt a dead peer's regions (data on the shared
            # object store; schema shipped in the message)
            if msg.get("table_info") is None:
                logger.error(
                    "open_regions for %s without table info; skipping",
                    msg.get("table"))
                return
            table = self.mito.adopt_regions(msg["table_info"],
                                            msg["region_numbers"])
            if self.catalog.table(msg["catalog"], msg["schema"],
                                  msg["table"]) is None:
                self.catalog.register_table(
                    msg["catalog"], msg["schema"], msg["table"], table)
        elif kind is not None and (kind.startswith("balancer_") or
                                   kind.startswith("repl_")):
            self._handle_balancer_msg(msg)

    # ---- elastic-region steps (meta/balancer.py's worker side) ----
    def _handle_balancer_msg(self, msg: dict) -> None:
        """Run one balancer step and ack the result to meta. SimulatedCrash
        (a BaseException) propagates — the torture harness, like a real
        SIGKILL, must see the step die before its ack."""
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
        kind = msg["type"]
        cat, sch, tbl = msg["catalog"], msg["schema"], msg["table"]
        if kind == "balancer_snapshot":
            # migrate step 1: make the region's full state durable on the
            # shared object store (ingest continues meanwhile)
            _fp.fail_point("balancer_snapshot_upload")
            _, region = self.mito._hosted(cat, sch, tbl, msg["region"])
            region.flush()
            return {"flushed_seq":
                    int(region.version_control.current.flushed_sequence)}
        if kind == "balancer_fence":
            # migrate step 2: stop the world for THIS region only, then
            # read the final WAL tail for the target to replay
            _, region = self.mito._hosted(cat, sch, tbl, msg["region"])
            region.fence()
            return {"wal_tail": region.wal_tail()}
        if kind == "balancer_open":
            # migrate step 3 (target side): last-flushed shared state +
            # shipped WAL tail = everything the source ever acked
            table = self.mito.adopt_region_with_tail(
                msg["table_info"], msg["region"], msg.get("wal_tail"))
            if self.catalog.table(cat, sch, tbl) is None:
                self.catalog.register_table(cat, sch, tbl, table)
            return {"replayed": len(msg.get("wal_tail") or [])}
        if kind == "balancer_release":
            gone = self.mito.release_region(cat, sch, tbl, msg["region"])
            if gone:
                self.catalog.deregister_table(cat, sch, tbl)
            return {"table_gone": gone}
        if kind == "balancer_unfence":
            table = self.catalog.table(cat, sch, tbl)
            region = (getattr(table, "regions", None) or {}).get(
                msg["region"])
            if region is not None and region.fenced:
                region.unfence()
            return {}
        if kind == "balancer_split_prepare":
            if msg.get("at_value") is None:
                # probe-only round: the balancer pins the value in the
                # op doc BEFORE any copy, so a re-delivered prepare
                # cannot re-probe a moved median and copy rows across a
                # different boundary (cross-child duplicates)
                value = self.mito.probe_split_value(
                    cat, sch, tbl, msg["region"])
                return {"split_value": value, "probed": True}
            _fp.fail_point("balancer_snapshot_upload")
            seq, copied = self.mito.prepare_split(
                cat, sch, tbl, msg["region"], list(msg["children"]),
                msg["at_value"])
            return {"split_value": msg["at_value"], "snapshot_seq": seq,
                    "copied": copied}
        if kind == "balancer_split_catchup":
            copied = self.mito.split_catchup(
                cat, sch, tbl, msg["region"], list(msg["children"]),
                msg["at_value"], int(msg["snapshot_seq"]))
            return {"copied": copied}
        if kind == "balancer_split_apply":
            self.mito.apply_split(cat, sch, tbl, msg["region"],
                                  list(msg["children"]), msg["rule"])
            return {}
        if kind == "balancer_split_abort":
            self.mito.abort_split(cat, sch, tbl, msg["region"],
                                  list(msg["children"]))
            return {}
        if kind == "repl_bootstrap":
            # replica-add step 2 (leader side): the WAL delta past the
            # snapshot's flushed sequence, WITHOUT fencing — ingest
            # continues; the continuous shipper covers records committed
            # after this read (followers dedup by sequence)
            _fp.fail_point("repl_bootstrap")
            _, region = self.mito._hosted(cat, sch, tbl, msg["region"])
            flushed = int(region.version_control.current.flushed_sequence)
            return {"wal_tail": region.wal_entries_since(flushed),
                    "flushed_seq": flushed}
        if kind == "repl_attach":
            # replica-add step 3 (follower side): adopt the last-flushed
            # shared state as a durable standby + replay the bootstrap
            # tail at its original sequences
            table = self.mito.adopt_standby(
                msg["table_info"], msg["region"], msg.get("wal_tail"))
            if self.catalog.table(cat, sch, tbl) is None:
                self.catalog.register_table(cat, sch, tbl, table)
            return {"replayed": len(msg.get("wal_tail") or [])}
        if kind == "repl_set_followers":
            # leader side, post-commit (and after failover promotions):
            # (re)wire the continuous shipper's follower set
            _, region = self.mito._hosted(cat, sch, tbl, msg["region"])
            n = self.replication.set_followers(
                cat, sch, tbl, msg["region"], region.name,
                list(msg.get("followers") or []))
            return {"followers": n}
        if kind == "repl_drop":
            # follower side: detach the standby (replica removed, or a
            # pre-commit replica-add rollback)
            gone = self.mito.release_region(cat, sch, tbl, msg["region"])
            if gone:
                self.catalog.deregister_table(cat, sch, tbl)
            return {"table_gone": gone}
        if kind == "repl_promote":
            # failover promotion (fire-and-forget from failover_check):
            # fence the dead leader's WAL dir, refresh from the shared
            # manifest, salvage + replay its surviving WAL records, then
            # take over as leader — zero acked rows lost
            _fp.fail_point("repl_promote")
            _, region = self.mito._hosted(cat, sch, tbl, msg["region"])
            if not getattr(region, "standby", False):
                # re-delivered promotion (meta retries the fire-and-
                # forget mail until a heartbeat confirms): already leader
                return {"salvaged": 0, "replayed": 0, "committed_seq":
                        int(region.version_control.committed_sequence)}
            old_id = msg.get("old_leader")
            old_dir = self._wal_dir_of(old_id, region.name) \
                if old_id is not None else None
            return self.mito.promote_standby(cat, sch, tbl, msg["region"],
                                             old_dir)
        raise UnsupportedError(f"unknown balancer step {kind!r}")

    def _wal_dir_of(self, node_id: int, region_name: str) -> str:
        """Another datanode's WAL dir for a region, on the SHARED
        data_home (mirrors EngineConfig.wal_home scoping) — promotion
        salvages a dead leader's acked-but-unflushed records from it."""
        if node_id:
            return os.path.join(self.opts.data_home, "nodes",
                                str(node_id), "wal", region_name)
        return os.path.join(self.opts.data_home, "wal", region_name)

    # ---- replica apply (follower side of the continuous ship path;
    # reached in-process via the shipper or over the repl_apply Flight
    # action) ----
    def repl_apply(self, catalog: str, schema: str, table: str,
                   region_number: int, entries: list,
                   leader_flushed: int = 0) -> dict:
        _fp.fail_point("repl_apply")
        _, region = self.mito._hosted(catalog, schema, table,
                                      region_number)
        if not region.standby:
            # already promoted (or never a standby): a late ship from a
            # deposed leader — ignore it; the WAL-dir fence keeps that
            # leader from acking anything new
            return {"replayed": 0, "standby": False, "committed_seq":
                    int(region.version_control.committed_sequence)}
        vc = region.version_control
        gap = bool(entries) and \
            int(entries[0]["seq"]) > vc.committed_sequence + 1
        if gap or int(leader_flushed or 0) > \
                vc.current.flushed_sequence:
            # the leader flushed past this replica's manifest view (or
            # shipped records skipped ahead): reopen from the CURRENT
            # shared manifest — it always covers the gap, and the reopen
            # bounds the standby's memtable to the leader's unflushed
            # window
            region = self.mito.refresh_standby(catalog, schema, table,
                                               region_number)
        replayed = region.ingest_wal_tail(entries) if entries else 0
        return {"replayed": replayed, "standby": True, "committed_seq":
                int(region.version_control.committed_sequence)}

    def shutdown(self) -> None:
        self.replication.stop()
        self.flow_manager.stop()
        if self._heartbeat_task is not None:
            self._heartbeat_task.stop()
        for engine in self.engines.values():
            engine.close()
        self.storage.close()
        with _live_lock:
            if _live_datanodes.get(int(self.opts.node_id)) is self:
                del _live_datanodes[int(self.opts.node_id)]
