"""Distributed frontend: DistTable + DistInstance.

Reference behavior: src/frontend — `DistTable` splits inserts per region
and routes them to owning datanodes (table.rs:83-107, splitter.rs:46-80);
`DistInstance` orchestrates distributed DDL: allocate a table id, have the
meta service build the table route (region→peer placement), then fan the
create out to each datanode with its region subset
(instance/distributed.rs:95-204,206-320).

The scan path pushes *aggregate moments* down to the datanodes
(client.region_moments — each datanode reduces its surviving regions with
the segment-moments kernel on its own device) and the frontend only folds
per-run moment frames; the reference ships only projection/filter/limit
scans (table.rs:109-156).

The data plane is a parallel, pruned scatter-gather executor:

- prune before fan-out — the query's tag/time predicates select regions
  through `partition_rule.find_regions_by_filters` (reference:
  src/partition/src/manager.rs:192), and only owning datanodes are
  contacted, with the surviving region list shipped over the wire so a
  datanode does not scan its pruned sibling regions either;
- concurrent fan-out with pipelined gather — per-datanode RPCs scatter
  through the shared `common/runtime` dist pool (bounded per statement
  by ``SET dist_fanout``) and results fold as they arrive, in submit
  order, instead of barriering on the slowest node; `_split_write`
  overlaps per-region WAL+memtable work the same way;
- robust + observable — each RPC retries transient faults
  (storage/retry.is_transient; the ``dist_rpc`` failpoint injects them,
  greptime_dist_rpc_retry_total counts them), a whole-table operation
  refreshes a stale route from meta and retries, and ExecStats reports
  ``regions pruned a/b, fan-out=k, slowest_node_ms`` per statement with
  one block per datanode (a Flight datanode's block keeps the `launches`
  its ExecStats shipped).

Ported from greptimedb_tpu/frontend/distributed.py. The frontend's
device is explicit: `DistInstance(meta, clients, device="cuda")` unless
the caller asks for "cpu", and without CUDA a "cuda" frontend raises, as
a datanode does; the aggregates reduce on the datanodes' devices either
way. PromQL over DistTables rides the same engine as standalone: lowered
aggregates scatter through the pushdown, the row path reads the selector
by a wire RawScan (promql/lowering.py) and builds its matrix on this
frontend's device. ADMIN MIGRATE / SPLIT / REBALANCE / ADD or REMOVE
REPLICA enqueue meta balancer operations; `SET read_replica` /
`replica_max_lag_ms` route reads to lag-bounded followers, as the
reference's do.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from ..catalog import MemoryCatalogManager
from ..client import DatanodeClient
from ..common import exec_stats
from ..common.failpoint import register as _fp_register
from ..common.runtime import env_int
from ..errors import (
    GreptimeError, InvalidArgumentsError, RegionClosedError,
    StaleRouteError, TableAlreadyExistsError, TableNotFoundError,
    UnsupportedError)
from ..meta import MetaClient, TableRoute
from ..partition import rule_from_partitions, split_rows
from ..query import QueryEngine
from ..session import QueryContext
from ..sql import ast
from ..table.metadata import TableIdent, TableInfo, TableMeta
from ..table.requests import CreateTableRequest
from ..table.table import Table

logger = logging.getLogger(__name__)

_fp_register("dist_rpc")


def _serialize_dist_rule(rule):
    from ..mito.engine import _serialize_rule
    return _serialize_rule(rule)


#: stale-route retries: attempts AFTER the first try for a statement
#: whose route moved mid-flight (failover, migrate, split) or whose
#: target region is fenced for an in-flight handoff. Backoff doubles from
#: _STALE_ROUTE_BASE_MS so the retries ride over the bounded fence
#: window instead of failing into the client.
_STALE_ROUTE_MAX_RETRIES = [env_int("GREPTIME_STALE_ROUTE_MAX_RETRIES", 6)]
_STALE_ROUTE_BASE_MS = [env_int("GREPTIME_STALE_ROUTE_BASE_MS", 50)]
_STALE_ROUTE_MAX_BACKOFF_MS = 2000

#: attempts AFTER the first try for one datanode RPC (0 disables retry)
_DIST_RPC_MAX_RETRIES = [env_int("GREPTIME_DIST_RPC_MAX_RETRIES", 2)]
#: first backoff; doubles per attempt, capped, ±50% jitter
_DIST_RPC_BASE_MS = [env_int("GREPTIME_DIST_RPC_RETRY_BASE_MS", 25)]
_DIST_RPC_MAX_BACKOFF_MS = 1000


def configure_dist_rpc_retry(*, max_retries: Optional[int] = None,
                             base_ms: Optional[int] = None) -> None:
    """SET dist_rpc_max_retries / dist_rpc_retry_base_ms."""
    if max_retries is not None:
        _DIST_RPC_MAX_RETRIES[0] = max(0, int(max_retries))
    if base_ms is not None:
        _DIST_RPC_BASE_MS[0] = max(1, int(base_ms))


#: replica-aware read routing: "leader" scatters reads to region leaders
#: only; "follower" lets reads land on read replicas whose replication
#: lag is inside the bounded-staleness budget below, balancing by
#: per-node assignment count. SET read_replica / SET replica_max_lag_ms
#: flip these at runtime; GREPTIME_* twins seed.
_READ_REPLICA = [os.environ.get("GREPTIME_READ_REPLICA",
                                "leader").strip().lower() or "leader"]
_REPLICA_MAX_LAG_MS = [env_int("GREPTIME_REPLICA_MAX_LAG_MS", 5000)]


def configure_read_replica(mode: Optional[str] = None,
                           max_lag_ms: Optional[int] = None) -> None:
    """SET read_replica = leader|follower / SET replica_max_lag_ms."""
    if mode is not None:
        mode = str(mode).strip().lower()
        if mode not in ("leader", "follower"):
            raise InvalidArgumentsError(
                f"read_replica: expected 'leader' or 'follower', "
                f"got {mode!r}")
        _READ_REPLICA[0] = mode
    if max_lag_ms is not None:
        try:
            _REPLICA_MAX_LAG_MS[0] = max(0, int(float(max_lag_ms)))
        except (TypeError, ValueError):
            raise InvalidArgumentsError(
                f"replica_max_lag_ms: expected a number, got "
                f"{max_lag_ms!r}")


def _dist_rpc(what: str, call):
    """Run one datanode RPC with transient-fault retry
    (storage/retry.is_transient): exponential backoff + jitter,
    greptime_dist_rpc_retry{,_giveup}_total counters. The `dist_rpc`
    failpoint fires inside the loop, so an injected err(transient)
    exercises the real retry path."""
    from ..common.failpoint import fail_point
    from ..common.telemetry import increment_counter
    from ..storage.retry import is_transient
    attempt = 0
    while True:
        try:
            fail_point("dist_rpc")
            return call()
        except Exception as e:  # noqa: BLE001 — classified below
            if not is_transient(e) or attempt >= _DIST_RPC_MAX_RETRIES[0]:
                if attempt:
                    increment_counter("dist_rpc_retry_giveup")
                raise
            attempt += 1
            increment_counter("dist_rpc_retry")
            delay_ms = min(_DIST_RPC_BASE_MS[0] * (2 ** (attempt - 1)),
                           _DIST_RPC_MAX_BACKOFF_MS)
            delay_s = delay_ms / 1e3 * (0.5 + random.random())
            logger.warning(
                "dist rpc %s failed transiently (%s); retry %d/%d in "
                "%.0fms", what, e, attempt, _DIST_RPC_MAX_RETRIES[0],
                delay_s * 1e3)
            time.sleep(delay_s)


class DistTable(Table):
    """Frontend-side view of a distributed table: route + clients.

    Holds no storage; every data operation prunes the region set by the
    statement's predicates, scatters bounded-parallel RPCs to the owning
    datanodes, and folds results as they arrive."""

    #: query/engine.py threads WHERE conjuncts + LIMIT into scan_batches
    #: for tables that advertise this
    supports_filter_pushdown = True

    def __init__(self, info: TableInfo, rule, route: TableRoute,
                 clients: Dict[int, DatanodeClient], meta=None):
        super().__init__(info)
        self.partition_rule = rule
        self.route = route
        self.clients = clients
        #: meta client for the stale-route refresh (regions move under
        #: live tables: failover, migrate, split); None degrades to no
        #: refresh — the StaleRouteError surfaces after the retries
        self.meta = meta
        self._warned_remote_regions = False
        #: per-node wall latency of the most recent scatter on this
        #: frontend ({label: ms})
        self.last_scatter_node_ms: Dict[str, float] = {}

    # ---- stale-route refresh ----
    def refresh_route(self) -> bool:
        """Re-pull the route AND the partition rule from meta: a failover
        or migrate changes placement, a split changes the rule + the
        region set. Returns whether anything was actually refreshed."""
        if self.meta is None:
            return False
        full = (f"{self.info.catalog_name}.{self.info.schema_name}."
                f"{self.info.name}")
        try:
            route = self.meta.route(full)
        except Exception:  # noqa: BLE001 — refresh is best-effort; the
            logger.exception(       # caller's retry loop handles failure
                "stale-route refresh of %s failed", full)
            return False
        if route is None:
            return False
        self.route = route
        info_doc = self.meta.table_info(full) \
            if hasattr(self.meta, "table_info") else None
        if info_doc:
            meta_doc = info_doc.get("meta", {})
            from ..mito.engine import _deserialize_rule
            self.partition_rule = _deserialize_rule(
                meta_doc.get("partition_rule"))
            self.info.meta.partition_rule = meta_doc.get("partition_rule")
            self.info.meta.region_numbers = sorted(
                rr.region_number for rr in route.region_routes)
        from ..common.telemetry import increment_counter
        increment_counter("stale_route_refresh")
        logger.info("refreshed route of %s to v%d (%d regions)", full,
                    route.version, len(route.region_routes))
        return True

    def _retry_stale(self, what: str, call):
        """Run a whole-table operation, refreshing the route and retrying
        on StaleRouteError — regions move under live statements (a
        failover's adoption, a migrate or split commit) or sit briefly
        fenced mid-handoff; the backoff rides over the bounded fence
        window."""
        from ..storage.retry import is_transient
        attempt = 0
        while True:
            try:
                return call()
            except GreptimeError as e:
                # retryable shapes: an explicit stale route; a datanode
                # whose LAST region of the table left (TableNotFound over
                # the wire); a peer the per-RPC retry gave up on that may
                # simply be DEAD (failover re-places its regions, so a
                # refresh covers the detection window). Everything else
                # propagates untouched.
                retryable = isinstance(
                    e, (StaleRouteError, TableNotFoundError,
                        RegionClosedError)) or \
                    is_transient(e)
                if not retryable or \
                        attempt >= _STALE_ROUTE_MAX_RETRIES[0]:
                    raise
                attempt += 1
                delay_ms = min(
                    _STALE_ROUTE_BASE_MS[0] * (2 ** (attempt - 1)),
                    _STALE_ROUTE_MAX_BACKOFF_MS)
                logger.info(
                    "%s of %s hit a stale route (%s); refresh + retry "
                    "%d/%d in %dms", what, self.info.name, e, attempt,
                    _STALE_ROUTE_MAX_RETRIES[0], delay_ms)
                time.sleep(delay_ms / 1e3 * (0.5 + random.random()))
                if not self.refresh_route() and \
                        isinstance(e, TableNotFoundError):
                    raise                  # the table is genuinely gone

    # ---- placement helpers ----
    def _owner(self, region_number: int) -> DatanodeClient:
        for rr in self.route.region_routes:
            if rr.region_number == region_number:
                client = self.clients.get(rr.leader.id)
                if client is None:
                    raise GreptimeError(
                        f"no client for datanode {rr.leader.id}")
                return client
        raise GreptimeError(f"region {region_number} not in route")

    def _involved_clients(self) -> List[DatanodeClient]:
        seen = {}
        for rr in self.route.region_routes:
            seen[rr.leader.id] = self.clients[rr.leader.id]
        return list(seen.values())

    @property
    def regions(self):
        """Union of the in-process regions across datanodes (the local
        frame cache of the CPU fallback walks these). A remote Flight
        client has no in-process datanode to reach into — and a PARTIAL
        union would be served as the whole table by cached_table_frame,
        so any remote client degrades the view to EMPTY with one WARN;
        callers then fall back to the wire scan path. The aggregate path
        never reads this: it scatters through execute_tpu_plan."""
        out = {}
        for client in self._involved_clients():
            datanode = getattr(client, "datanode", None)
            if datanode is None:
                if not self._warned_remote_regions:
                    self._warned_remote_regions = True
                    logger.warning(
                        "DistTable %s.regions: datanode %s is remote; "
                        "in-process region metadata is unavailable — "
                        "returning no regions (reads go over the wire)",
                        self.info.name,
                        getattr(client, "node_id", "?"))
                return {}
            dn_table = datanode.catalog.table(
                self.info.catalog_name, self.info.schema_name,
                self.info.name)
            if dn_table is not None:
                # skip standby replicas: the leader's copy of the same
                # region number is the authoritative one for the union
                out.update({rn: reg for rn, reg
                            in dn_table.regions.items()
                            if not getattr(reg, "standby", False)})
        return out

    # ---- pruning ----
    def _all_region_numbers(self) -> List[int]:
        return sorted(rr.region_number for rr in self.route.region_routes)

    def _prune_regions(self, filters=None, time_lo=None, time_hi=None,
                       time_range=None) -> Tuple[List[int], int]:
        """(surviving region numbers, total routed regions) for the
        statement's predicates. Pruning is advisory: any failure falls
        back to the full region set — it must never fail a query."""
        all_regions = self._all_region_numbers()
        rule = self.partition_rule
        if rule is None:
            return all_regions, len(all_regions)
        preds = list(filters or ())
        tc = self.schema.timestamp_column
        if tc is not None:
            los = [time_lo]
            his = [time_hi]
            if time_range is not None:
                if hasattr(time_range, "start"):
                    los.append(time_range.start)
                    his.append(time_range.end)
                else:
                    lo, hi = time_range
                    los.append(lo)
                    his.append(hi)
            los = [v for v in los if v is not None]
            his = [v for v in his if v is not None]
            # time-range overlap joins the rule's predicate pruning when
            # the table partitions on its time index ([lo, hi) half-open)
            if los:
                preds.append(ast.BinaryOp(">=", ast.Column(tc.name),
                                          ast.Literal(int(max(los)))))
            if his:
                preds.append(ast.BinaryOp("<", ast.Column(tc.name),
                                          ast.Literal(int(min(his)))))
        try:
            survivors = rule.find_regions_by_filters(preds)
        except Exception:  # noqa: BLE001 — pruning is an optimization
            logger.exception("partition pruning failed; contacting all "
                             "regions of %s", self.info.name)
            survivors = rule.region_numbers()
        routed = set(all_regions)
        return [r for r in survivors if r in routed], len(all_regions)

    def _owners_for(self, region_numbers: Sequence[int]
                    ) -> List[Tuple[DatanodeClient, List[int]]]:
        """Surviving regions grouped by owning datanode, in stable
        datanode-id order — one scatter target per datanode."""
        wanted = set(region_numbers)
        by_node: Dict[int, List[int]] = {}
        for rr in self.route.region_routes:
            if rr.region_number in wanted:
                by_node.setdefault(rr.leader.id, []).append(
                    rr.region_number)
        out = []
        for node_id in sorted(by_node):
            client = self.clients.get(node_id)
            if client is None:
                raise GreptimeError(f"no client for datanode {node_id}")
            out.append((client, sorted(by_node[node_id])))
        return out

    #: region_peers cache TTL for replica routing: one meta read serves
    #: a read burst; lag only moves at heartbeat cadence anyway
    _REPLICA_TTL_S = 5.0

    def _replica_candidates(self) -> Dict[int, List[int]]:
        """{region_number: [alive follower node ids inside the lag
        bound]} from meta's region_peers, TTL-cached per route version.
        Empty on any failure — replica routing is an optimization and
        must never fail a read (it degrades to the leader)."""
        if self.meta is None or not hasattr(self.meta, "region_peers"):
            return {}
        now = time.monotonic()
        cache = getattr(self, "_replica_cache", None)
        if cache is not None and cache[0] > now and \
                cache[1] == self.route.version:
            return cache[2]
        max_lag = _REPLICA_MAX_LAG_MS[0]
        full = (f"{self.info.catalog_name}.{self.info.schema_name}."
                f"{self.info.name}")
        out: Dict[int, List[int]] = {}
        try:
            for row in self.meta.region_peers():
                if row.get("table_name") != full or \
                        row.get("is_leader") == "Yes" or \
                        row.get("status") != "ALIVE":
                    continue
                lag = row.get("lag_ms")
                if lag is None or lag > max_lag:
                    continue
                out.setdefault(int(row["region_number"]), []).append(
                    int(row["peer_id"]))
        except Exception:  # noqa: BLE001 — degrade to leader reads
            logger.exception("replica candidate lookup for %s failed; "
                             "reads stay on leaders", full)
            out = {}
        self._replica_cache = (now + self._REPLICA_TTL_S,
                               self.route.version, out)
        return out

    def _read_owners_for(self, region_numbers: Sequence[int]
                         ) -> List[Tuple[DatanodeClient, List[int]]]:
        """Scatter targets for a READ. Leader-only unless SET
        read_replica = 'follower': then each region picks the least-
        assigned node among its leader and lag-bounded followers,
        spreading a hot table's read QPS across its replicas. Writes
        always use _owners_for — only the leader may ack."""
        if _READ_REPLICA[0] != "follower":
            return self._owners_for(region_numbers)
        candidates = self._replica_candidates()
        if not candidates:
            return self._owners_for(region_numbers)
        wanted = set(region_numbers)
        count: Dict[int, int] = {}
        assigned: Dict[int, List[int]] = {}
        # rotating start keeps successive queries spreading over the
        # pool (a single-region table would otherwise pin every read to
        # the tie-winning leader and replicas would never take traffic)
        rot = self._read_rr = getattr(self, "_read_rr", 0) + 1
        for rr in sorted(self.route.region_routes,
                         key=lambda r: r.region_number):
            if rr.region_number not in wanted:
                continue
            pool = [rr.leader.id] + [
                n for n in candidates.get(rr.region_number, ())
                if n in self.clients]
            pool = pool[rot % len(pool):] + pool[:rot % len(pool)]
            # least-assigned within this scatter; min() keeps the first
            # (rotated) entry on ties
            pick = min(pool, key=lambda n: count.get(n, 0))
            count[pick] = count.get(pick, 0) + 1
            assigned.setdefault(pick, []).append(rr.region_number)
        out = []
        for node_id in sorted(assigned):
            client = self.clients.get(node_id)
            if client is None:
                raise GreptimeError(f"no client for datanode {node_id}")
            out.append((client, sorted(assigned[node_id])))
        return out

    # ---- scatter-gather core ----
    def _scatter(self, targets, call, what: str, node_ms=None):
        """Yield (result, elapsed_ms) per datanode target, in submit
        order as results complete (pipelined gather on the shared dist
        pool, in-flight window = SET dist_fanout). Each RPC retries
        transient faults via _dist_rpc.

        Observability: each RPC runs under its OWN ExecStats
        sub-collector — datanode-side stages (recorded in-process by
        LocalDatanodeClient, or absorbed from the wire response by
        FlightDatanodeClient, `launches` included) land there instead of
        flat on the statement. The sub-collector attaches to the
        statement's collector as a per-node block for the EXPLAIN
        ANALYZE tree on the CONSUMER side of the gather, so a straggler
        RPC finishing after the caller abandoned the gather (limit
        break) records nothing — node blocks are exactly the results
        the statement consumed. The per-hop wall time feeds the dist_rpc
        latency histogram, and `node_ms` (when a list is passed)
        collects the per-node latency vector."""
        from ..common import process_list, runtime
        from ..common.telemetry import observe_latency
        from ..common.telemetry import span as _span
        parent = exec_stats.current()

        def one(target):
            client, regs = target
            label = f"dn{getattr(client, 'node_id', '?')}"
            holder = {"stats": None, "t0": 0.0}

            def attempt():
                # fresh sub-collector per attempt: a transient failure
                # mid-scan must not leave its half-recorded stages to
                # double-count under the retry. The clock restarts per
                # attempt too — a failed attempt + backoff sleep is NOT
                # network time
                holder["t0"] = time.perf_counter()
                ns = exec_stats.ExecStats() if parent is not None \
                    else None
                holder["stats"] = ns
                # per-hop span: its self-time (RPC wall minus the
                # datanode-side span) is the network share
                with exec_stats.collect_into(ns), \
                        _span("dist_rpc", peer=label, what=what):
                    return call(client, regs)

            res = _dist_rpc(f"{what}[{label}]", attempt)
            wall_ms = (time.perf_counter() - holder["t0"]) * 1e3
            observe_latency("dist_rpc_hop", wall_ms / 1e3, what=what)
            return res, wall_ms, label, holder["stats"]

        for res, wall_ms, label, stats in runtime.parallel_imap(
                one, targets, max_workers=runtime.dist_fanout(),
                pool=runtime.dist_runtime()):
            # cooperative KILL at the gather boundary: raising here
            # closes the bounded gather, whose finally cancels every
            # queued RPC — a killed fan-out frees its dist-pool slots
            # instead of orphaning futures
            process_list.check_cancelled()
            if parent is not None and stats is not None:
                parent.record_node(label, stats, wall_ms)
                parent.record("dist_scatter", rpcs=1)
            if node_ms is not None:
                node_ms.append((label, wall_ms))
            yield res, wall_ms

    def _record_scatter(self, survivors: int, total: int, fan_out: int
                        ) -> None:
        exec_stats.record(
            "dist_scatter",
            scatter=f"regions pruned {total - survivors}/{total}, "
                    f"fan-out={fan_out}")

    # ---- writes ----
    def insert(self, columns: Dict[str, Sequence]) -> int:
        return self._split_write(columns, op="put")

    def bulk_load(self, columns: Dict[str, Sequence]) -> int:
        """Route a WAL-less bulk load to each owning datanode's region
        (mito write_region op="bulk" → Region.bulk_ingest)."""
        return self._split_write(columns, op="bulk")

    def delete(self, key_columns: Dict[str, Sequence]) -> int:
        return self._split_write(key_columns, op="delete")

    def _split_write(self, columns: Dict[str, Sequence], op: str) -> int:
        if not columns:
            return 0
        num_rows = len(next(iter(columns.values())))
        for name, vals in columns.items():
            if len(vals) != num_rows:
                raise InvalidArgumentsError(f"ragged column {name!r}")
        splits = split_rows(self.partition_rule, columns, num_rows) \
            if self.partition_rule is not None else {self._first_region(): None}
        tasks = []
        for rnum, idx in splits.items():
            part = columns if idx is None else \
                {k: v[idx] if isinstance(v, np.ndarray)
                 else [v[i] for i in idx] for k, v in columns.items()}
            tasks.append((rnum, part))

        def write_one(task):
            rnum, part = task
            try:
                return _dist_rpc(
                    f"write_region[{rnum}]",
                    lambda: self._owner(rnum).write_region(
                        self.info.catalog_name, self.info.schema_name,
                        self.info.name, rnum, part, op))
            except GreptimeError as e:
                # also covers _owner()'s "region not in route" against a
                # refreshed-but-shrunk route; only stale-route shapes
                # re-route — everything else propagates. A CLOSED region
                # is one: the node died or released it (failover moves
                # the lease, so the refreshed route points elsewhere)
                if not isinstance(e, (StaleRouteError,
                                      RegionClosedError)) and \
                        "not in route" not in str(e):
                    raise
                # the region moved or was refined away mid-statement:
                # re-split ONLY this part under the fresh rule —
                # completed sibling parts must not double-count
                return self._rewrite_stale_part(part, op)

        # per-REGION scatter: a multi-region insert/bulk load overlaps
        # WAL+memtable (or SST encode) work across datanodes instead of
        # paying the sum of its splits
        from ..common import runtime
        written = sum(runtime.parallel_map(
            write_one, tasks, max_workers=runtime.dist_fanout(),
            pool=runtime.dist_runtime()))
        if len(tasks) > 1:
            exec_stats.record("dist_write", rows=written,
                              fan_out=len(tasks), rpcs=len(tasks))
        return written

    def _rewrite_stale_part(self, part: Dict[str, Sequence],
                            op: str) -> int:
        """Re-route one failed write part after a stale-route refresh:
        the refined rule may fan the SAME rows across different (child)
        regions. Retries with backoff ride over the fenced handoff
        window; re-writes are MVCC-idempotent upserts, so a row that DID
        land before the error cannot duplicate."""
        attempt = 0
        while True:
            attempt += 1
            if attempt > _STALE_ROUTE_MAX_RETRIES[0]:
                raise StaleRouteError(
                    f"write to {self.info.name} still stale after "
                    f"{attempt - 1} route refreshes")
            delay_ms = min(_STALE_ROUTE_BASE_MS[0] * (2 ** (attempt - 1)),
                           _STALE_ROUTE_MAX_BACKOFF_MS)
            time.sleep(delay_ms / 1e3 * (0.5 + random.random()))
            self.refresh_route()
            num_rows = len(next(iter(part.values())))
            splits = split_rows(self.partition_rule, part, num_rows) \
                if self.partition_rule is not None \
                else {self._first_region(): None}
            try:
                written = 0
                for rnum, idx in splits.items():
                    piece = part if idx is None else \
                        {k: v[idx] if isinstance(v, np.ndarray)
                         else [v[i] for i in idx] for k, v in part.items()}
                    written += _dist_rpc(
                        f"write_region[{rnum}]",
                        lambda r=rnum, p=piece: self._owner(r).write_region(
                            self.info.catalog_name, self.info.schema_name,
                            self.info.name, r, p, op))
                from ..common.telemetry import increment_counter
                increment_counter("stale_route_write_reroutes")
                return written
            except (StaleRouteError, RegionClosedError) as e:
                logger.info("re-routed write to %s still stale (%s); "
                            "retry %d/%d", self.info.name, e, attempt,
                            _STALE_ROUTE_MAX_RETRIES[0])

    def _first_region(self) -> int:
        return self.route.region_routes[0].region_number

    # ---- reads ----
    def scan_batches(self, projection: Optional[Sequence[str]] = None,
                     time_range=None, limit: Optional[int] = None,
                     filters: Optional[Sequence] = None) -> list:
        """Pruned parallel scan with stale-route refresh: a datanode that
        no longer hosts a requested region raises StaleRouteError instead
        of returning partial rows, and the whole scan re-plans under the
        fresh route."""
        return self._retry_stale(
            "scan", lambda: self._scan_batches_once(
                projection=projection, time_range=time_range,
                limit=limit, filters=filters))

    def _scan_batches_once(self, projection: Optional[Sequence[str]] = None,
                           time_range=None, limit: Optional[int] = None,
                           filters: Optional[Sequence] = None) -> list:
        """One pruned parallel scan pass. `filters` are the statement's
        WHERE conjuncts (query/engine.py): they prune regions here, and
        the pushable tag subset also ships over the wire so datanodes
        drop dead rows before they ever cross a socket. `limit` travels
        only when the shipped subset IS the whole predicate — otherwise a
        frontend-side re-filter could leave fewer than `limit` rows."""
        from ..mito.engine import pushable_tag_filter
        filters = list(filters or ())
        survivors, total = self._prune_regions(filters=filters,
                                               time_range=time_range)
        targets = self._read_owners_for(survivors)
        tag_names = self.schema.tag_names()
        ship = [f for f in filters if pushable_tag_filter(f, tag_names)]
        wire_limit = limit if limit is not None and \
            len(ship) == len(filters) else None
        self._record_scatter(len(survivors), total, len(targets))
        out: list = []
        rows = 0
        node_ms: list = []
        for batches, dt_ms in self._scatter(
                targets,
                lambda c, regs: c.scan_batches(
                    self.info.catalog_name, self.info.schema_name,
                    self.info.name, projection=projection,
                    time_range=time_range, limit=wire_limit,
                    filters=ship or None, regions=regs),
                what="scan", node_ms=node_ms):
            out.extend(batches)
            rows += sum(b.num_rows for b in batches)
            if wire_limit is not None and rows >= wire_limit:
                # enough rows: abandoning the gather cancels queued RPCs
                # (the shipped filters ARE the predicate when a limit
                # travels, so any `limit` matching rows answer exactly)
                break
        self._record_node_vector(rows, node_ms)
        return out

    def _record_node_vector(self, rows: int, node_ms: list) -> None:
        """The per-node latency vector (not just its max) — rendered in
        the dist_scatter detail and kept on the table. String values: a
        statement that scatters twice must not SUM its latencies
        (numeric details accumulate in ExecStats)."""
        slowest = max((ms for _, ms in node_ms), default=0.0)
        vector = "/".join(
            f"{label}:{ms:.1f}" for label, ms in sorted(
                node_ms, key=lambda kv: exec_stats.node_sort_key(kv[0]))
        ) or "-"
        self.last_scatter_node_ms = {label: ms for label, ms in node_ms}
        exec_stats.record("dist_scatter", rows=rows,
                          slowest_node_ms=f"{slowest:.2f}",
                          node_ms=vector)

    def _plan_scatter(self, plan):
        """(survivors, total, targets, cost) for an aggregate plan,
        memoized on the plan object — try_execute asks for the dispatch
        string (scatter_describe) right before execute_tpu_plan runs the
        same plan, and the route + cost walk should happen once. Keyed
        on the route version too: a stale-route refresh mid-statement
        must re-plan instead of re-using a scatter over regions that
        just moved."""
        cached = getattr(plan, "_dist_scatter_cache", None)
        if cached is not None and cached[0] is self and \
                cached[1] == self.route.version:
            return cached[2]
        survivors, total = self._prune_regions(
            filters=plan.tag_predicates, time_lo=plan.time_lo,
            time_hi=plan.time_hi)
        targets = self._read_owners_for(survivors)
        cost = self._plan_cost(plan, survivors)
        result = (survivors, total, targets, cost)
        plan._dist_scatter_cache = (self, self.route.version, result)
        return result

    # ---- cost-based dispatch ----
    #: heartbeat-estimate cache TTL: one meta read serves a burst of
    #: statements; heat only moves at heartbeat cadence anyway
    _HEAT_TTL_S = 5.0

    def _region_estimates(self, wanted: Sequence[int]
                          ) -> Dict[int, Tuple[int, int, int]]:
        """{region_number: (rows, series, time_span)} for the cost
        planner, restricted to `wanted` (the plan's surviving regions —
        pruned siblings must not pay the SST-meta walk). In-process
        datanodes are walked directly (SST/memtable stats + series-dict
        counts); regions behind a wire client fall back to the meta
        heartbeat's region_stats — the same numbers, one stat beat
        stale. Results are TTL-cached per route version, so a statement
        burst pays one walk. Regions neither walkable nor
        heartbeat-known stay absent and the planner defaults to partial
        pushdown. Estimation must never fail a query."""
        now = time.monotonic()
        cache = getattr(self, "_est_cache", None)
        if cache is None or cache[0] <= now or \
                cache[2] != self.route.version:
            cache = (now + self._HEAT_TTL_S,
                     {}, self.route.version)
            self._est_cache = cache
        est: Dict[int, Tuple[int, int, int]] = cache[1]
        todo = [rn for rn in wanted if rn not in est]
        if not todo:
            return est
        from ..query.stream_exec import (region_estimated_rows,
                                         region_time_span)
        by_number = {rr.region_number: rr
                     for rr in self.route.region_routes}
        missing: List[int] = []
        for rn in todo:
            rr = by_number.get(rn)
            client = self.clients.get(rr.leader.id) \
                if rr is not None else None
            datanode = getattr(client, "datanode", None)
            if datanode is None:
                missing.append(rn)
                continue
            try:
                t = datanode.catalog.table(
                    self.info.catalog_name, self.info.schema_name,
                    self.info.name)
                region = t.regions.get(rn) if t is not None else None
                if region is None:
                    missing.append(rn)
                    continue
                sd = getattr(region, "series_dict", None)
                est[rn] = (
                    region_estimated_rows(region),
                    int(getattr(sd, "num_series", 0) or 0),
                    region_time_span(region))
            except Exception:  # noqa: BLE001 — estimates are advisory:
                # an unwalkable region leaves the map partial and the
                # planner defaults to pushdown
                from ..common.telemetry import increment_counter
                increment_counter("cost_estimate_errors")
                missing.append(rn)
                continue
        if missing:
            from ..mito.engine import region_name
            heat = self._heartbeat_estimates()
            for rn in missing:
                found = heat.get(region_name(self.info.ident.table_id,
                                             rn))
                if found is not None:
                    est[rn] = found
        return est

    def _heartbeat_estimates(self) -> Dict[str, Tuple[int, int, int]]:
        """{region name: (rows, series, time_span)} from the meta
        service's heartbeat-fed region stats, TTL-cached per table so a
        statement burst costs one meta read. Empty (and still cached,
        bounding the retry rate) when meta is unreachable or not the
        leader — the planner then defaults to pushdown."""
        cached = getattr(self, "_heat_cache", None)
        now = time.monotonic()
        if cached is not None and cached[0] > now:
            return cached[1]
        heat: Dict[str, Tuple[int, int, int]] = {}
        if self.meta is not None and hasattr(self.meta, "region_heat"):
            try:
                for h in self.meta.region_heat():
                    heat[str(h["region"])] = (
                        int(h.get("rows", 0) or 0),
                        int(h.get("series", 0) or 0),
                        int(h.get("time_span", 0) or 0))
            except Exception:  # noqa: BLE001 — advisory: a follower
                # meta or a flaky hop degrades to pushdown-by-default
                from ..common.telemetry import increment_counter
                increment_counter("cost_estimate_errors")
                heat = {}
        self._heat_cache = (now + self._HEAT_TTL_S, heat)
        return heat

    def _plan_cost(self, plan, survivors) -> Optional[dict]:
        """Estimated result cardinality + wire bytes for this plan over
        the surviving regions, and the partial-pushdown vs raw-pull
        choice. None = no estimate (remote datanodes without stats):
        pushdown by default.

        The model: each region's GROUP BY yields at most
        min(rows, series × buckets) partial groups; a partial group
        costs its moment widths (8B numeric, bounded sketch frames for
        distinct/t-digest); a raw row costs its projected columns.
        Raw-pull wins only when the partial frames would outweigh the
        raw rows ~2x — the GROUP BY keys are nearly unique and a
        per-group sketch carries more than the rows it summarizes."""
        from ..query import sketches
        from ..query.tpu_exec import plan_scan_columns
        est = self._region_estimates(survivors)
        if not survivors or any(r not in est for r in survivors):
            return None
        rows = 0
        groups = 0
        stride = plan.bucket.stride_ms if plan.bucket is not None else None
        for r in survivors:
            n, series, span = est[r]
            if n == 0:
                continue
            rows += n
            g = max(1, series) if plan.tag_groups else 1
            if stride:
                g *= max(1, min(n, -(-max(span, 1) // stride)))
            groups += min(n, g)
        if rows == 0:
            return {"mode": "pushdown", "est_rows": 0, "est_groups": 0}
        rows_per_g = max(1, rows // max(groups, 1))
        per_g = 8 * (len(plan.tag_groups) +
                     (1 if plan.bucket else 0) + 1)   # keys + __rowcount
        for m in plan.moments:
            if m.op == "distinct":
                per_g += min(
                    8 * min(rows_per_g, sketches.EXACT_SET_LIMIT) + 40,
                    (1 << sketches.hll_precision()) + 16)
            elif m.op == "tdigest":
                per_g += 16 * min(rows_per_g,
                                  int(sketches.tdigest_delta())) + 44
            else:
                per_g += 8
        partial_b = groups * per_g
        raw_b = rows * (20 + 8 * len(plan_scan_columns(plan,
                                                       self.schema)))
        mode = "raw" if partial_b > 2 * raw_b else "pushdown"
        return {"mode": mode, "est_rows": int(rows),
                "est_groups": int(groups), "partial_bytes": int(partial_b),
                "raw_bytes": int(raw_b)}

    def execute_tpu_plan(self, plan) -> List[pd.DataFrame]:
        """Aggregate pushdown: prune regions by the plan's tag/time
        predicates, then each surviving datanode reduces ONLY its
        surviving regions on its device; moment frames fold as they
        arrive. Stale routes re-plan + retry like the scan path."""
        return self._retry_stale(
            "aggregate", lambda: self._execute_tpu_plan_once(plan))

    def _execute_tpu_plan_once(self, plan) -> List[pd.DataFrame]:
        survivors, total, targets, cost = self._plan_scatter(plan)
        if cost is not None and cost["mode"] == "raw":
            # cost-based choice: the partial frames would outweigh the
            # raw rows — UnsupportedError sends try_execute to the
            # raw-row scatter, under the SAME dispatch line
            # scatter_describe already printed
            raise UnsupportedError(
                f"cost-based dispatch chose raw-pull (est "
                f"{cost['est_rows']} rows -> {cost['est_groups']} "
                f"groups)")
        self._record_scatter(len(survivors), total, len(targets))
        frames: List[pd.DataFrame] = []
        node_ms: list = []
        for part, dt_ms in self._scatter(
                targets,
                lambda c, regs: c.region_moments(
                    self.info.catalog_name, self.info.schema_name,
                    self.info.name, plan, regions=regs),
                what="region_moments", node_ms=node_ms):
            frames.extend(part)        # fold-as-they-arrive gather
        self._record_node_vector(0, node_ms)
        return frames

    def scatter_describe(self, plan) -> str:
        """The pruned-scatter dispatch line shared by EXPLAIN and
        execution (query/tpu_exec.dispatch_decision_for_pushdown) —
        including the cost-based partial-pushdown vs raw-pull choice
        with its row estimates, so EXPLAIN, EXPLAIN ANALYZE and the
        executed path render ONE decision."""
        survivors, total, targets, cost = self._plan_scatter(plan)
        prefix = (f"regions pruned {total - len(survivors)}/{total}, "
                  f"fan-out={len(targets)}")
        if cost is None:
            return (f"aggregate-pushdown ({prefix}; "
                    f"datanodes reduce, frontend folds)")
        est = (f"est_rows={cost['est_rows']} -> "
               f"est_groups={cost['est_groups']}")
        if cost["mode"] == "raw":
            return (f"raw-pull ({prefix}; {est}, partial frames would "
                    f"outweigh raw rows; datanodes ship rows, frontend "
                    f"aggregates)")
        return (f"aggregate-pushdown ({prefix}; {est}; "
                f"datanodes reduce, frontend folds)")

    def flush(self) -> None:
        """Flush every datanode's regions concurrently."""
        def once():
            for _ in self._scatter(
                    self._owners_for(self._all_region_numbers()),
                    lambda c, regs: c.flush_table(
                        self.info.catalog_name, self.info.schema_name,
                        self.info.name),
                    what="flush_table"):
                pass
        self._retry_stale("flush", once)


class _RouteHydratingCatalog(MemoryCatalogManager):
    """Frontend catalog that falls back to the meta routes on a miss
    (reference: FrontendCatalogManager resolves through the meta KV on
    demand, src/frontend/src/catalog.rs). Hydration happens at table-
    resolution depth, so every statement shape — SELECT, INSERT..SELECT,
    DESCRIBE — sees remote tables on a fresh frontend."""

    def __init__(self, instance: "DistInstance"):
        super().__init__()
        self._instance = instance
        self._miss_guard = threading.local()

    def table(self, catalog: str, schema: str, name: str):
        t = super().table(catalog, schema, name)
        if t is not None or getattr(self._miss_guard, "busy", False):
            return t
        self._miss_guard.busy = True
        try:
            route = self._instance.meta.route(
                f"{catalog}.{schema}.{name}")
            if route is None:
                return None
            return self._instance._hydrate_table(route, catalog, schema,
                                                 name)
        finally:
            self._miss_guard.busy = False


class DistInstance:
    """Distributed frontend instance (reference DistInstance).

    Wires: meta client (routes/ids/heartbeats) + one DatanodeClient per
    worker + a frontend-local catalog of DistTables + the query engine
    on `device` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, meta: MetaClient,
                 clients: Dict[int, DatanodeClient], device="cuda"):
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            # no CPU fallback: a caller who wants the CPU asks for it
            raise RuntimeError(
                f"CUDA is not available: the frontend's query engine runs "
                f"on {device!r} (pass device='cpu' to run on the CPU)")
        self.meta = meta
        self.clients = clients
        self.catalog = _RouteHydratingCatalog(self)
        # information_schema.cluster_info resolves through the meta
        # client hanging off the catalog (both frontends serve the view)
        self.catalog.meta_client = meta
        self.query_engine = QueryEngine(self.catalog, device=device)
        # continuous rollup flows: specs live in the meta kv so every
        # frontend (and a restarted one) sees the same flows; folds run
        # through the generic scan-based path over DistTables
        from ..flow import FlowManager, KvFlowStore
        store = KvFlowStore(meta) \
            if hasattr(meta, "kv_put") or hasattr(meta, "put") else None
        self.flow_manager = FlowManager(
            self.catalog, store, create_sink_fn=self._create_flow_sink,
            device=device)
        self.flow_manager.recover()
        self.query_engine.flow_manager = self.flow_manager
        self.catalog.flow_manager = self.flow_manager
        # self-monitoring: the frontend scrapes its own registry plus the
        # meta service's cluster-wide region heat (heartbeat-derived)
        # into greptime_private tables, written through the normal
        # distributed ingest path. Background ticking is opt-in
        # (self_monitor.start_background) — `frontend start` wires it;
        # tests drive tick() cooperatively.
        from ..common import (background_jobs, process_list, profiler,
                              trace_store)
        from ..monitor import SelfMonitor
        self.self_monitor = SelfMonitor(self, node_label="frontend",
                                        meta=meta)
        self.catalog.self_monitor = self.self_monitor
        process_list.configure_node("frontend")
        background_jobs.configure_node("frontend")
        # durable trace store, root role: this frontend decides the tail
        # verdict for its statements' traces; datanode spans buffer
        # remotely until the verdict piggybacks on a later RPC (or the
        # in-process datanodes of a test cluster share this very sink)
        self.trace_sink = trace_store.TraceSink(
            node_label="frontend", service="frontend", role="root",
            writer=self)
        trace_store.install(self.trace_sink)
        self.catalog.trace_sink = self.trace_sink
        # continuous profiler, same root role: samples taken on this
        # frontend flush through the self-monitor path; datanode-side
        # samples drain over the Flight `profile` action on demand
        self.profiler = profiler.Profiler(node_label="frontend",
                                          writer=self)
        profiler.install(self.profiler)
        # information_schema.background_jobs fans out to every
        # reachable datanode and merges (compactions run THERE)
        self.catalog.dist_clients = clients
        #: coprocessor scripts: the HTTP server builds the engine on
        #: first use, on the query engine's device
        self.script_engine = None
        self._tql_engine = None

    def shutdown(self) -> None:
        """Stop the frontend's own background work (the datanodes and
        the meta client belong to the caller)."""
        self.self_monitor.stop()
        self.profiler.stop(join=False)

    def _create_flow_sink(self, spec, schema, pk_indices):
        """Materialize a flow sink as an ordinary distributed table."""
        cols = []
        for cs in schema.column_schemas:
            cols.append(ast.ColumnDef(
                name=cs.name, type_name=cs.dtype.name,
                nullable=cs.nullable,
                is_time_index=cs.is_time_index,
                is_primary_key=cs.is_tag))
        stmt = ast.CreateTable(
            name=ast.ObjectName([spec.catalog, spec.schema, spec.sink]),
            columns=cols,
            time_index=spec.ts_column,
            primary_keys=[c.name for c in schema.column_schemas
                          if c.is_tag],
            if_not_exists=True)
        ctx = QueryContext(spec.catalog, spec.schema)
        return self.create_table(stmt, ctx)

    # ---- DDL ----
    def create_table(self, stmt: ast.CreateTable,
                     ctx: Optional[QueryContext] = None) -> DistTable:
        from .statement import build_schema_from_create
        ctx = ctx or QueryContext()
        catalog, schema_name, table_name = ctx.resolve(stmt.name)
        full = f"{catalog}.{schema_name}.{table_name}"
        if self.catalog.table(catalog, schema_name, table_name) \
                is not None:
            if stmt.if_not_exists:
                return self.catalog.table(catalog, schema_name, table_name)
            raise TableAlreadyExistsError(f"table {full} already exists")

        existing_route = self.meta.route(full)
        if existing_route is not None:
            # frontend restart / second frontend: reattach to the live
            # table instead of failing an idempotent statement
            table = self._hydrate_table(existing_route, catalog,
                                        schema_name, table_name)
            if stmt.if_not_exists and table is not None:
                return table
            raise TableAlreadyExistsError(f"table {full} already exists")

        schema, pk_indices = build_schema_from_create(stmt)
        rule = rule_from_partitions(stmt.partitions) \
            if stmt.partitions is not None else None
        region_numbers = rule.region_numbers() if rule is not None else [0]

        # 1. meta: allocate id + place regions on alive datanodes
        route = self.meta.create_route(full, region_numbers)
        try:
            # 2. fan out: each datanode creates its region subset
            for peer in route.peers():
                client = self.clients.get(peer.id)
                if client is None:
                    raise GreptimeError(f"no client for datanode {peer.id}")
                client.ddl_create_table(CreateTableRequest(
                    table_name, schema,
                    catalog_name=catalog, schema_name=schema_name,
                    primary_key_indices=pk_indices,
                    create_if_not_exists=True,
                    table_options=dict(stmt.options or {}),
                    partitions=stmt.partitions,
                    table_id=route.table_id,
                    assigned_region_numbers=route.regions_on(peer.id)))
        except Exception:
            # roll back: route + any datanode that already created its part
            self.meta.delete_route(full)
            for peer in route.peers():
                client = self.clients.get(peer.id)
                if client is None:
                    continue
                try:
                    client.ddl_drop_table(catalog, schema_name, table_name)
                except Exception:  # noqa: BLE001
                    logger.exception(
                        "rollback drop on datanode %d failed", peer.id)
            raise

        info = TableInfo(
            ident=TableIdent(route.table_id),
            name=table_name,
            meta=TableMeta(schema=schema,
                           primary_key_indices=pk_indices,
                           engine="mito",
                           region_numbers=list(region_numbers),
                           next_column_id=len(schema),
                           options=dict(stmt.options or {}),
                           partition_rule=_serialize_dist_rule(rule)),
            catalog_name=catalog, schema_name=schema_name)
        # schema travels with the route (TableGlobalValue) so failover
        # can materialize regions on datanodes that never saw the DDL
        if hasattr(self.meta, "put_table_info"):
            self.meta.put_table_info(full, info.to_dict())
        table = DistTable(info, rule, route, self.clients,
                          meta=self.meta)
        self.catalog.register_table(catalog, schema_name, table_name, table)
        return table

    def drop_table(self, stmt: ast.DropTable,
                   ctx: Optional[QueryContext] = None) -> bool:
        ctx = ctx or QueryContext()
        catalog, schema_name, name = ctx.resolve(stmt.name)
        table = self._resolve_table(catalog, schema_name, name)
        if table is None:
            if stmt.if_exists:
                return False
            raise TableNotFoundError(f"table {name} not found")
        for client in table._involved_clients():
            client.ddl_drop_table(catalog, schema_name, name)
        self.meta.delete_route(f"{catalog}.{schema_name}.{name}")
        if hasattr(self.meta, "delete_table_info"):
            self.meta.delete_table_info(f"{catalog}.{schema_name}.{name}")
        self.catalog.deregister_table(catalog, schema_name, name)
        return True

    def _resolve_table(self, catalog: str, schema_name: str, name: str):
        """Local catalog first, then rebuild a DistTable from the meta
        route (frontend restart path)."""
        table = self.catalog.table(catalog, schema_name, name)
        if table is not None:
            return table
        route = self.meta.route(f"{catalog}.{schema_name}.{name}")
        if route is None:
            return None
        return self._hydrate_table(route, catalog, schema_name, name)

    def _hydrate_table(self, route: TableRoute, catalog: str,
                       schema_name: str, name: str) -> Optional[DistTable]:
        """Rebuild the frontend-side DistTable from the route + a hosting
        datanode's local table metadata."""
        for peer in route.peers():
            client = self.clients.get(peer.id)
            if client is None:
                continue
            described = client.describe_table(catalog, schema_name, name)
            if described is None:
                continue
            info, rule = described
            region_numbers = sorted(
                rr.region_number for rr in route.region_routes)
            info = TableInfo(
                ident=TableIdent(route.table_id), name=name,
                meta=TableMeta(
                    schema=info.meta.schema,
                    primary_key_indices=list(
                        info.meta.primary_key_indices),
                    engine=info.meta.engine,
                    region_numbers=region_numbers,
                    next_column_id=info.meta.next_column_id,
                    options=dict(info.meta.options)),
                catalog_name=catalog, schema_name=schema_name)
            table = DistTable(info, rule, route, self.clients,
                              meta=self.meta)
            self.catalog.register_table(catalog, schema_name, name, table)
            return table
        return None

    # ---- protocol ingest: auto create / alter on demand ----
    def handle_bulk_load(
        self, table_name: str, columns: Dict[str, Sequence],
        *, tag_columns: Sequence[str] = (),
        timestamp_column: str = "greptime_timestamp",
        types=None, ctx: Optional[QueryContext] = None,
    ) -> int:
        """Distributed bulk load: same auto create/alter as row insert,
        but each datanode ingests its partition WAL-less
        (DistTable.bulk_load → write_region op="bulk")."""
        return self.handle_row_insert(
            table_name, columns, tag_columns=tag_columns,
            timestamp_column=timestamp_column, types=types, ctx=ctx,
            _bulk=True)

    def handle_row_insert(
        self, table_name: str, columns: Dict[str, Sequence],
        *, tag_columns: Sequence[str] = (),
        timestamp_column: str = "greptime_timestamp",
        types=None, ctx: Optional[QueryContext] = None,
        _bulk: bool = False,
    ) -> int:
        """Distributed twin of the standalone auto-create/alter ingest
        (reference: DistInstance implements the same handler traits,
        src/frontend/src/instance.rs:83-97). Auto-created tables get one
        region placed by the meta selector; missing field columns fan
        an ALTER out to every owning datanode."""
        from .instance import build_ingest_schema, infer_ingest_type
        ctx = ctx or QueryContext()
        catalog, schema_name = ctx.current_catalog, ctx.current_schema
        table = self._resolve_table(catalog, schema_name, table_name)
        if table is None:
            schema, pk = build_ingest_schema(columns, tag_columns,
                                             timestamp_column, types)
            full = f"{catalog}.{schema_name}.{table_name}"
            route = self.meta.create_route(full, [0])
            for peer in route.peers():
                self.clients[peer.id].ddl_create_table(CreateTableRequest(
                    table_name, schema, catalog_name=catalog,
                    schema_name=schema_name, primary_key_indices=pk,
                    create_if_not_exists=True, table_id=route.table_id,
                    assigned_region_numbers=route.regions_on(peer.id)))
            info = TableInfo(
                ident=TableIdent(route.table_id), name=table_name,
                meta=TableMeta(schema=schema, primary_key_indices=pk,
                               engine="mito", region_numbers=[0],
                               next_column_id=len(schema)),
                catalog_name=catalog, schema_name=schema_name)
            table = DistTable(info, None, route, self.clients,
                              meta=self.meta)
            try:
                self.catalog.register_table(catalog, schema_name,
                                            table_name, table)
            except TableAlreadyExistsError:
                # concurrent protocol auto-create race: adopt the
                # winner's registration — the datanode-side create was
                # already if-not-exists
                existing = self._resolve_table(catalog, schema_name,
                                               table_name)
                if existing is not None:
                    table = existing
        else:
            missing = [n for n in columns
                       if not table.schema.contains(n)]
            new_tags = [n for n in missing if n in set(tag_columns)]
            if new_tags:
                raise InvalidArgumentsError(
                    f"table {table_name!r} has no tag column(s) "
                    f"{new_tags}; tags cannot be added after create")
            if missing:
                from ..datatypes.schema import ColumnSchema
                from ..table.requests import (
                    AddColumnRequest, AlterKind, AlterTableRequest)
                adds = [AddColumnRequest(ColumnSchema(
                    n, infer_ingest_type(n, columns[n], types or {}, "")))
                    for n in missing]
                req = AlterTableRequest(
                    table_name, AlterKind.ADD_COLUMNS,
                    catalog_name=catalog, schema_name=schema_name,
                    add_columns=adds)
                for client in table._involved_clients():
                    client.ddl_alter_table(req)
                # refresh the frontend view from a datanode's new schema
                self.catalog.deregister_table(catalog, schema_name,
                                              table_name)
                table = self._resolve_table(catalog, schema_name,
                                            table_name)
        return table.bulk_load(columns) if _bulk else table.insert(columns)

    def alter_table(self, stmt: ast.AlterTable, ctx: QueryContext):
        """Distributed ALTER: fan the engine request out to every owning
        datanode, then refresh the frontend view (and, for RENAME, move
        the meta route so the table resolves under its new name).
        Reference: dist DDL via meta procedures,
        src/frontend/src/instance/distributed.rs + alter flow in
        src/table/src/metadata.rs:249-297."""
        from ..query.output import Output
        from ..table.requests import (
            AddColumnRequest, AlterKind, AlterTableRequest)
        from .statement import build_column_schema
        catalog, schema_name, table_name = ctx.resolve(stmt.table)
        table = self._resolve_table(catalog, schema_name, table_name)
        if table is None:
            raise TableNotFoundError(f"table {table_name!r} not found")
        op = stmt.operation
        if isinstance(op, ast.AddColumn):
            cs = build_column_schema(op.column, is_tag=False,
                                     is_time_index=False)
            req = AlterTableRequest(
                table_name, AlterKind.ADD_COLUMNS, catalog_name=catalog,
                schema_name=schema_name,
                add_columns=[AddColumnRequest(cs, location=op.location)])
        elif isinstance(op, ast.DropColumn):
            req = AlterTableRequest(
                table_name, AlterKind.DROP_COLUMNS, catalog_name=catalog,
                schema_name=schema_name, drop_columns=[op.name])
        elif isinstance(op, ast.RenameTable):
            req = AlterTableRequest(
                table_name, AlterKind.RENAME_TABLE, catalog_name=catalog,
                schema_name=schema_name, new_table_name=op.new_name)
        else:
            raise UnsupportedError(f"ALTER operation {type(op).__name__}")
        for client in table._involved_clients():
            client.ddl_alter_table(req)
        self.catalog.deregister_table(catalog, schema_name, table_name)
        if isinstance(op, ast.RenameTable):
            self.meta.rename_route(
                f"{catalog}.{schema_name}.{table_name}",
                f"{catalog}.{schema_name}.{op.new_name}")
            self._resolve_table(catalog, schema_name, op.new_name)
        else:
            self._resolve_table(catalog, schema_name, table_name)
        return Output.rows(0)

    # ---- SQL ----
    def do_query(self, sql: str, ctx: Optional[QueryContext] = None):
        from ..common import process_list
        from ..common.admission import GATE as _admission
        from ..common.telemetry import (
            increment_counter, observe_latency, slow_query_threshold_ms,
            span, timer)
        from ..sql import parse_statements
        ctx = ctx or QueryContext()
        outs = []
        for stmt in parse_statements(sql):
            # same admission gate as the standalone frontend: reject
            # past the in-flight limit, KILL/SET always admitted
            _admission.admit_statement(type(stmt).__name__)
            t0 = time.perf_counter()
            prev_stats = self.query_engine.last_exec_stats
            try:
                with span("execute_stmt", stmt=type(stmt).__name__,
                          distributed=True) as sp, timer("stmt_execute"), \
                        process_list.track(
                            sql, protocol=ctx.channel.value,
                            catalog=ctx.current_catalog,
                            schema=ctx.current_schema,
                            trace_id=sp["trace_id"]):
                    outs.append(self.execute_stmt(stmt, ctx))
            finally:
                # finally: failing statements must count in the
                # latency distribution too
                observe_latency(
                    "stmt_latency", time.perf_counter() - t0,
                    stmt=type(stmt).__name__,
                    protocol=ctx.channel.value)
            increment_counter(f"stmt_{type(stmt).__name__.lower()}")
            elapsed_ms = (time.perf_counter() - t0) * 1e3
            thr = slow_query_threshold_ms()
            if thr is not None and elapsed_ms >= thr:
                stats = self.query_engine.last_exec_stats
                if stats is prev_stats:     # not this statement's stats
                    stats = None
                from ..common import profiler, trace_store
                sink = trace_store.sink()
                logging.getLogger("greptimedb_tpu_torch.slow_query").warning(
                    "slow query: %.1fms (threshold %dms) trace=%s "
                    "trace_stored=%s%s stmt=%r stats=[%s]", elapsed_ms,
                    thr, sp["trace_id"],
                    sink.stored_verdict(sp["trace_id"])
                    if sink is not None else "off",
                    profiler.slow_query_suffix(sp["trace_id"]), sql,
                    stats.summary() if stats is not None else "n/a")
        return outs

    def execute_stmt(self, stmt, ctx: QueryContext):
        from ..query.output import Output
        if isinstance(stmt, ast.CreateTable):
            self.create_table(stmt, ctx)
            return Output.rows(0)
        if isinstance(stmt, ast.DropTable):
            self.drop_table(stmt, ctx)
            return Output.rows(0)
        if isinstance(stmt, ast.AlterTable):
            return self.alter_table(stmt, ctx)
        if isinstance(stmt, ast.Insert):
            return self._insert(stmt, ctx)
        if isinstance(stmt, ast.Delete):
            return self._delete(stmt, ctx)
        if isinstance(stmt, ast.CreateFlow):
            self.flow_manager.create_flow(stmt, ctx)
            return Output.rows(0)
        if isinstance(stmt, ast.DropFlow):
            self.flow_manager.drop_flow(stmt.name, ctx,
                                        if_exists=stmt.if_exists)
            return Output.rows(0)
        if isinstance(stmt, ast.ShowFlows):
            from .statement import show_flows_output
            return show_flows_output(self.flow_manager, stmt, ctx)
        if isinstance(stmt, ast.SetVariable):
            # balancer knobs forward to meta-srv (the balancer lives on
            # the meta leader); everything else is the shared handler
            name = stmt.name.lower()
            if name.startswith("balancer_") and \
                    hasattr(self.meta, "balancer_configure"):
                self.meta.balancer_configure(
                    name[len("balancer_"):], stmt.value)
                return Output.rows(0)
            if name in ("read_replica", "replica_max_lag_ms"):
                # replica-aware read routing is frontend-local state
                # (each frontend scatters its own reads)
                if name == "read_replica":
                    configure_read_replica(mode=stmt.value)
                else:
                    configure_read_replica(max_lag_ms=stmt.value)
                return Output.rows(0)
            from .statement import apply_set_variable
            return apply_set_variable(stmt, ctx)
        if isinstance(stmt, ast.Kill):
            from .statement import apply_kill
            return apply_kill(stmt)
        if isinstance(stmt, ast.Admin):
            return self._admin(stmt, ctx)
        if isinstance(stmt, ast.Tql):
            return self.execute_tql(stmt, ctx)
        return self.query_engine.execute(stmt, ctx)

    def promql_engine(self):
        """Lazily-built, shared PromQL engine (TQL and the Prometheus
        API), on the query engine's device. Its selectors resolve
        DistTables from this frontend's catalog, so lowerable aggregates
        scatter TpuPlans to the datanodes and non-lowerable shapes ride
        the IR raw scan (region pruning + wire filter pushdown)."""
        if self._tql_engine is None:
            from ..promql.engine import PromqlEngine
            self._tql_engine = PromqlEngine(self.catalog,
                                            device=self.query_engine.device)
        return self._tql_engine

    def execute_tql(self, stmt: ast.Tql, ctx: QueryContext):
        return self.promql_engine().execute_tql(stmt, ctx)

    def _admin(self, stmt: ast.Admin, ctx: QueryContext):
        """ADMIN MIGRATE/SPLIT/REBALANCE → meta balancer ops. Async by
        design (the reference's migrate_region returns a procedure id):
        the returned op id tracks progress in region_peers."""
        from .statement import admin_ops_output
        if stmt.kind in ("flush_table", "compact_table"):
            from .statement import apply_admin_maintenance
            return apply_admin_maintenance(self.catalog, stmt, ctx)
        if stmt.kind == "show_trace":
            # sync first: a ping per datanode piggybacks this frontend's
            # verdicts and collects any released buffered spans, so the
            # waterfall is complete even though the query long finished
            from .statement import apply_show_trace
            return apply_show_trace(self.catalog, stmt,
                                    sync_clients=list(
                                        self.clients.values()))
        if stmt.kind == "show_profile":
            # drain every datanode's pending sample aggregate over the
            # Flight `profile` action, flush locally, then read the
            # per-node tree back out of greptime_private
            from .statement import apply_show_profile
            return apply_show_profile(self.catalog, stmt,
                                      sync_clients=list(
                                          self.clients.values()))
        if stmt.kind == "rebalance":
            full = None
            if stmt.table is not None:
                catalog, schema_name, name = ctx.resolve(stmt.table)
                full = f"{catalog}.{schema_name}.{name}"
            return admin_ops_output(self.meta.admin_rebalance(full))
        catalog, schema_name, name = ctx.resolve(stmt.table)
        full = f"{catalog}.{schema_name}.{name}"
        if self._resolve_table(catalog, schema_name, name) is None:
            raise TableNotFoundError(f"table {name!r} not found")
        if stmt.kind == "migrate_region":
            op = self.meta.admin_migrate_region(full, stmt.region,
                                                stmt.target_node)
        elif stmt.kind == "split_region":
            op = self.meta.admin_split_region(full, stmt.region,
                                              stmt.at_value)
        elif stmt.kind == "add_replica":
            op = self.meta.admin_add_replica(full, stmt.region,
                                             stmt.target_node)
        elif stmt.kind == "remove_replica":
            op = self.meta.admin_remove_replica(full, stmt.region,
                                                stmt.target_node)
        else:
            raise UnsupportedError(f"ADMIN {stmt.kind}")
        return admin_ops_output([op])

    def _insert(self, stmt: ast.Insert, ctx: QueryContext):
        from ..errors import ColumnNotFoundError
        from ..query.output import Output
        from .statement import evaluate_insert_rows
        catalog, schema_name, table_name = ctx.resolve(stmt.table)
        table = self._resolve_table(catalog, schema_name, table_name)
        if table is None:
            raise TableNotFoundError(f"table {table_name} not found")
        schema = table.schema
        columns = stmt.columns or schema.names()
        for c in columns:
            if not schema.contains(c):
                raise ColumnNotFoundError(
                    f"column {c!r} not found in {table_name!r}")
        cols = evaluate_insert_rows(stmt, columns, self.query_engine, ctx)
        return Output.rows(table.insert(cols))

    def _delete(self, stmt: ast.Delete, ctx: QueryContext):
        from .statement import delete_matching_rows
        catalog, schema_name, table_name = ctx.resolve(stmt.table)
        table = self.catalog.table(catalog, schema_name, table_name)
        if table is None:
            raise TableNotFoundError(f"table {table_name} not found")
        return delete_matching_rows(table, stmt)
