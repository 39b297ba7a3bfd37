"""MitoEngine + MitoTable.

Layout on the object store (mirrors the reference's `table_dir`/
`region_name` scheme, src/table/src/engine.rs):

    mito/engine.json                       — next_table_id + table registry
    mito/{catalog}/{schema}/{table_id}/manifest.json — TableInfo
    region data under region name "{table_id}_{region_number:010d}"

DDL ordering follows the reference's manifest-first create
(src/mito/src/engine/procedure/create.rs): persist the table manifest, then
create regions, then register — recovery re-opens from the manifest.

Ported from greptimedb_tpu/mito/engine.py for the standalone deployment:
the layout and documents are the reference's, so either package opens the
other's data home. The distributed methods (region adoption on failover,
standby replicas, region release and split) are not ported yet.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import MITO_ENGINE
from ..common.time import TimestampRange
from ..datatypes.record_batch import RecordBatch
from ..datatypes.schema import Schema, SemanticType
from ..errors import (
    ColumnExistsError,
    ColumnNotFoundError,
    InvalidArgumentsError,
    RegionNotFoundError,
    TableAlreadyExistsError,
    TableNotFoundError,
)
from ..partition import rule_from_partitions, split_rows
from ..partition.rule import (
    MAXVALUE,
    HashPartitionRule,
    PartitionRule,
    RangeColumnsPartitionRule,
    RangePartitionRule,
)
from ..storage.engine import StorageEngine
from ..storage.region import Region
from ..storage.write_batch import WriteBatch
from ..table.metadata import TableIdent, TableInfo, TableMeta
from ..table.requests import (
    AlterKind,
    AlterTableRequest,
    CreateTableRequest,
    DropTableRequest,
    OpenTableRequest,
)
from ..table.table import Table, TableEngine

MIN_USER_TABLE_ID = 1024


def region_opts_from_table_options(options: Dict) -> Optional[Dict]:
    """Map CREATE TABLE WITH(...) options onto region knobs
    (ttl='7d', compaction_time_window='1h')."""
    from ..common.time import parse_duration_ms
    opts = {}
    ttl = options.get("ttl")
    if ttl:
        opts["ttl_ms"] = parse_duration_ms(str(ttl))
    cw = options.get("compaction_time_window")
    if cw:
        opts["compaction_time_window_ms"] = parse_duration_ms(str(cw))
    return opts or None


def region_name(table_id: int, region_number: int) -> str:
    return f"{table_id}_{region_number:010d}"


def region_rows_columns(region, seq_gt: Optional[int] = None):
    """One region's merged live rows as an ingest-shaped column dict
    (tags decoded, None for NULL fields), optionally restricted to rows
    committed AFTER `seq_gt` — the split copy's source view. Returns
    (columns, snapshot_visible_sequence)."""
    snap = region.snapshot()
    visible = snap.visible_sequence
    data = snap.read_merged()
    if data.num_rows == 0:
        return {}, visible
    if seq_gt is not None and data.seq is not None:
        keep = data.seq > seq_gt
        if not keep.any():
            return {}, visible
        import dataclasses
        data = dataclasses.replace(
            data,
            series_ids=data.series_ids[keep], ts=data.ts[keep],
            seq=data.seq[keep],
            op_types=data.op_types[keep]
            if data.op_types is not None else None,
            fields={n: (d[keep], vd[keep] if vd is not None else None)
                    for n, (d, vd) in data.fields.items()})
    sd = data.series_dict
    cols: Dict[str, object] = {}
    for i, tag in enumerate(sd.tag_names):
        cols[tag] = sd.decode_tag_column(data.series_ids, i)
    tc = region.schema.timestamp_column
    if tc is not None:
        cols[tc.name] = data.ts
    for name, (vals, valid) in data.fields.items():
        if valid is None or bool(valid.all()):
            cols[name] = vals
        else:
            arr = np.empty(len(vals), dtype=object)
            arr[:] = vals
            arr[~valid] = None
            cols[name] = list(arr)
    return cols, visible


def _serialize_rule(rule: Optional[PartitionRule]) -> Optional[dict]:
    if rule is None:
        return None

    def enc(v):
        return {"maxvalue": True} if v is MAXVALUE else v

    if isinstance(rule, RangePartitionRule):
        return {"kind": "range", "column": rule.column,
                "bounds": [enc(b) for b in rule.bounds],
                "regions": rule.regions}
    if isinstance(rule, RangeColumnsPartitionRule):
        return {"kind": "range_columns", "columns": rule.columns,
                "bounds": [[enc(v) for v in b] for b in rule.bounds],
                "regions": rule.regions}
    if isinstance(rule, HashPartitionRule):
        return {"kind": "hash", "columns": rule.columns,
                "regions": rule.regions}
    raise InvalidArgumentsError(f"unserializable rule {type(rule)}")


def _deserialize_rule(d: Optional[dict]) -> Optional[PartitionRule]:
    if d is None:
        return None

    def dec(v):
        return MAXVALUE if isinstance(v, dict) and v.get("maxvalue") else v

    if d["kind"] == "hash":
        return HashPartitionRule(list(d["columns"]), list(d["regions"]))
    if d["kind"] == "range":
        return RangePartitionRule(d["column"], [dec(b) for b in d["bounds"]],
                                  list(d["regions"]))
    return RangeColumnsPartitionRule(
        list(d["columns"]), [tuple(dec(v) for v in b) for b in d["bounds"]],
        list(d["regions"]))


#: comparison shapes a datanode can apply exactly on its tag columns —
#: the frontend only pushes `limit` over the wire when EVERY conjunct is
#: pushable by this definition, so both sides must share it
_PUSHABLE_OPS = {"=", "!=", "<", "<=", ">", ">="}


def pushable_tag_filter(e, tag_names) -> bool:
    """True iff `e` is a tag-vs-literal predicate the scan path can apply
    exactly (shared by DistTable's wire encoder and the datanode)."""
    from ..sql.ast import BinaryOp, Column, InList, Literal
    tags = set(tag_names)
    if isinstance(e, BinaryOp) and e.op in _PUSHABLE_OPS:
        for col, lit in ((e.left, e.right), (e.right, e.left)):
            if isinstance(col, Column) and col.name in tags and \
                    isinstance(lit, Literal) and lit.value is not None:
                return True
        return False
    if isinstance(e, InList) and isinstance(e.expr, Column) and \
            e.expr.name in tags and e.items:
        return all(isinstance(i, Literal) and i.value is not None
                   for i in e.items)
    return False


def sid_candidates_for_filters(series_dict, tag_names,
                               filters) -> Optional[np.ndarray]:
    """Sorted candidate series-id set from the point (`tag = literal`)
    and non-negated `tag IN (...)` conjuncts of `filters`, resolved
    through the series dictionary — the sid sets the per-SST secondary
    index (storage/index.py) prunes files and row groups with.

    Returns None when no such conjunct exists (nothing selective to
    prune on: `!=`, ranges and regex-shaped predicates are deliberately
    EXCLUDED — their sid sets are near-total, so consulting blooms would
    cost without shedding). The result is a SUPERSET guarantee, not a
    filter: every row matching ALL conjuncts has a sid in the set, so
    callers still apply the full predicate downstream and answers cannot
    drift. An equality on a never-seen value resolves to the empty set —
    exact, and it prunes every file."""
    from ..sql.ast import BinaryOp, Column, InList, Literal
    tags = set(tag_names)
    cand: Optional[np.ndarray] = None
    for e in filters:
        col = None
        vals = None
        if isinstance(e, BinaryOp) and e.op == "=":
            for c, lit in ((e.left, e.right), (e.right, e.left)):
                if isinstance(c, Column) and c.name in tags and \
                        isinstance(lit, Literal) and lit.value is not None:
                    col, vals = c.name, [lit.value]
                    break
        elif isinstance(e, InList) and not e.negated and \
                isinstance(e.expr, Column) and e.expr.name in tags and \
                e.items and all(isinstance(i, Literal) and
                                i.value is not None for i in e.items):
            col, vals = e.expr.name, [i.value for i in e.items]
        if col is None:
            continue
        sids = series_dict.sids_for_tag_values(tag_names.index(col), vals)
        cand = sids if cand is None else \
            np.intersect1d(cand, sids, assume_unique=True)
        if cand is not None and len(cand) == 0:
            break                       # provably empty: nothing matches
    return cand


def _tag_series_keep(series_dict, tag_names, filters) -> np.ndarray:
    """Per-series keep mask for pushable tag filters: predicates evaluate
    once per SERIES (via the dictionary), not once per row, then broadcast
    through series_ids. NULL tags compare UNKNOWN → dropped, matching the
    engine's `mask.fillna(False)` WHERE semantics."""
    import operator
    from ..sql.ast import BinaryOp, Column, InList, Literal
    ops = {"=": operator.eq, "!=": operator.ne, "<": operator.lt,
           "<=": operator.le, ">": operator.gt, ">=": operator.ge}
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
    S = series_dict.num_series
    keep = np.ones(S, dtype=bool)
    ids = np.arange(S, dtype=np.int32)
    cache: Dict[str, list] = {}

    def col_values(name: str):
        if name not in cache:
            cache[name] = series_dict.decode_tag_column(
                ids, tag_names.index(name))
        return cache[name]

    for e in filters:
        if isinstance(e, BinaryOp):
            op = e.op
            if isinstance(e.left, Column) and isinstance(e.right, Literal):
                col, lit = e.left, e.right
            else:
                col, lit = e.right, e.left
                op = flip.get(op, op)
            vals = col_values(col.name)
            fn = ops[op]
            m = np.zeros(S, dtype=bool)
            for i, v in enumerate(vals):
                if v is None:
                    continue
                try:
                    m[i] = bool(fn(v, lit.value))
                except TypeError:
                    m[i] = False
            keep &= m
        elif isinstance(e, InList):
            items = {i.value for i in e.items}
            vals = col_values(e.expr.name)
            m = np.fromiter(
                ((v is not None) and ((v in items) != e.negated)
                 for v in vals), dtype=bool, count=S)
            keep &= m
    return keep


class MitoTable(Table):
    def __init__(self, info: TableInfo, regions: Dict[int, Region],
                 rule: Optional[PartitionRule] = None):
        super().__init__(info)
        self.regions = regions
        self.partition_rule = rule

    # ---- writes ----
    def insert(self, columns: Dict[str, Sequence]) -> int:
        if not columns:
            return 0
        num_rows = len(next(iter(columns.values())))
        for name, vals in columns.items():
            if len(vals) != num_rows:
                raise InvalidArgumentsError(
                    f"ragged insert column {name!r}")
        splits = split_rows(self.partition_rule, columns, num_rows) \
            if self.partition_rule is not None \
            else {min(self.regions): None}
        written = 0
        for rnum, idx in splits.items():
            region = self.regions.get(rnum)
            if region is None:
                raise RegionNotFoundError(
                    f"rows target region {rnum}, which this node does not "
                    f"host for table {self.info.name} (distributed writes "
                    f"must go through the frontend router)")
            if idx is None:
                part = columns
            else:
                part = {k: [v[i] for i in idx] for k, v in columns.items()}
            wb = WriteBatch(region.schema)
            wb.put(part)
            region.write(wb)
            written += num_rows if idx is None else len(idx)
        return written

    def bulk_load(self, columns: Dict[str, Sequence]) -> int:
        """WAL-less bulk ingestion straight to SSTs (COPY FROM / loader
        path): same routing as insert, ~10x the throughput of the
        WAL+memtable write path (Region.bulk_ingest)."""
        if not columns:
            return 0
        from ..common.telemetry import span
        num_rows = len(next(iter(columns.values())))
        with span("bulk_load", table=self.info.name, rows=num_rows):
            return self._bulk_load_inner(columns, num_rows)

    def _bulk_load_inner(self, columns: Dict[str, Sequence],
                         num_rows: int) -> int:
        for name, vals in columns.items():
            if len(vals) != num_rows:
                raise InvalidArgumentsError(
                    f"ragged bulk_load column {name!r}")
        splits = split_rows(self.partition_rule, columns, num_rows) \
            if self.partition_rule is not None \
            else {min(self.regions): None}
        written = 0
        for rnum, idx in splits.items():
            region = self.regions.get(rnum)
            if region is None:
                raise RegionNotFoundError(
                    f"rows target region {rnum}, which this node does not "
                    f"host for table {self.info.name}")
            # lists stay lists under the split (an object-ndarray round
            # trip would feed None-bearing numerics to astype, which
            # rejects None) — typed ndarrays keep the raw fast path
            part = columns if idx is None else \
                {k: v[idx] if isinstance(v, np.ndarray)
                 else [v[i] for i in idx]
                 for k, v in columns.items()}
            written += region.bulk_ingest(part)
        return written

    def delete(self, key_columns: Dict[str, Sequence]) -> int:
        if not key_columns:
            return 0
        num_rows = len(next(iter(key_columns.values())))
        splits = split_rows(self.partition_rule, key_columns, num_rows) \
            if self.partition_rule is not None \
            else {min(self.regions): None}
        deleted = 0
        for rnum, idx in splits.items():
            region = self.regions.get(rnum)
            if region is None:
                raise RegionNotFoundError(
                    f"rows target region {rnum}, which this node does not "
                    f"host for table {self.info.name}")
            part = key_columns if idx is None else \
                {k: [v[i] for i in idx] for k, v in key_columns.items()}
            wb = WriteBatch(region.schema)
            wb.delete(part)
            region.write(wb)
            deleted += num_rows if idx is None else len(idx)
        return deleted

    def write_region(self, region_number: int,
                     columns: Dict[str, Sequence],
                     op: str = "put") -> int:
        """Distributed write path: rows pre-split by the frontend land on
        one specific region (reference: datanode handles per-region
        inserts, src/datanode/src/instance/grpc.rs:124-160)."""
        region = self.regions.get(region_number)
        if region is None:
            # typed so the DistTable refreshes its route and retries —
            # the region moved (migrate) or was refined away (split)
            from ..errors import StaleRouteError
            raise StaleRouteError(
                f"region {region_number} of table {self.info.name} is "
                f"not hosted here (it may have moved)")
        if op == "bulk":
            # WAL-less direct-to-SST load (frontend bulk routing)
            return region.bulk_ingest(columns)
        wb = WriteBatch(region.schema)
        if op == "put":
            wb.put(columns)
        else:
            wb.delete(columns)
        region.write(wb)
        return len(next(iter(columns.values()))) if columns else 0

    # ---- reads ----
    def scan_raw(self, projection: Optional[Sequence[str]] = None,
                 time_range: Optional[TimestampRange] = None):
        return [r.snapshot().scan(projection=projection,
                                  time_range=time_range)
                for r in self.regions.values()]

    def scan_batches(self, projection: Optional[Sequence[str]] = None,
                     time_range: Optional[TimestampRange] = None,
                     limit: Optional[int] = None,
                     filters: Optional[Sequence] = None,
                     regions: Optional[Sequence[int]] = None
                     ) -> List[RecordBatch]:
        """`filters`: pushable tag predicates applied region-side so a
        pruned distributed scan stops shipping dead rows; `regions`:
        restrict to this subset of hosted region numbers (the frontend's
        surviving-region list — without it a datanode would scan its
        un-pruned sibling regions too)."""
        out: List[RecordBatch] = []
        remaining = limit
        schema = self.schema if projection is None \
            else self.schema.project(self._scan_columns(projection))
        tag_names = self.schema.tag_names()
        usable = [f for f in (filters or ())
                  if pushable_tag_filter(f, tag_names)]
        if regions is not None:
            missing = set(regions) - set(self.regions)
            if missing:
                # silently skipping would return PARTIAL results for a
                # frontend whose route predates a migrate/split; typed so
                # it refreshes and retries instead
                from ..errors import StaleRouteError
                raise StaleRouteError(
                    f"region(s) {sorted(missing)} of table "
                    f"{self.info.name} are not hosted here")
        hosted = self.regions if regions is None else \
            {rn: r for rn, r in self.regions.items() if rn in set(regions)}
        from ..storage.index import sst_index_enabled
        for region in hosted.values():
            # point/IN conjuncts resolve to sid sets per REGION (series
            # dictionaries are region-local) so the scan prunes whole
            # SSTs through their index sidecars — this is the datanode
            # side of the wire-pushed tag filters too
            sid_set = None
            if usable and sst_index_enabled():
                sid_set = sid_candidates_for_filters(
                    region.series_dict, tag_names, usable)
            data = region.snapshot().read_merged(
                projection=projection, time_range=time_range,
                sid_set=sid_set)
            if usable and data.num_rows:
                keep = _tag_series_keep(data.series_dict, tag_names,
                                        usable)
                if not keep.all():
                    import dataclasses
                    sel = keep[data.series_ids]
                    data = dataclasses.replace(
                        data,
                        series_ids=data.series_ids[sel],
                        ts=data.ts[sel],
                        seq=data.seq[sel] if data.seq is not None else None,
                        op_types=data.op_types[sel]
                        if data.op_types is not None else None,
                        fields={n: (d[sel],
                                    vd[sel] if vd is not None else None)
                                for n, (d, vd) in data.fields.items()})
            rb = self._scan_data_to_batch(data, schema)
            if remaining is not None:
                rb = rb.slice(0, min(remaining, rb.num_rows))
                remaining -= rb.num_rows
            out.append(rb)
            if remaining is not None and remaining <= 0:
                break
        return out

    def _scan_columns(self, projection: Sequence[str]) -> List[str]:
        return [c.name for c in self.schema.column_schemas
                if c.name in projection]

    def _scan_data_to_batch(self, data, schema: Schema) -> RecordBatch:
        """SoA scan arrays → RecordBatch with zero per-value Python: the
        scan already holds numpy columns + validity bitmaps, so vectors
        wrap them directly (small-query latency is conversion-bound)."""
        from ..datatypes.vector import Vector
        import numpy as np
        sd = data.series_dict
        vectors = []
        for c in schema.column_schemas:
            if c.is_tag:
                tag_idx = self.schema.tag_names().index(c.name)
                decoded = sd.decode_tag_column(data.series_ids, tag_idx)
                arr = np.empty(len(decoded), dtype=object)
                arr[:] = decoded
                vectors.append(Vector(c.dtype, arr))
            elif c.is_time_index:
                vectors.append(Vector.from_numpy(data.ts, c.dtype))
            elif c.name in data.fields:
                vals, valid = data.fields[c.name]
                if vals.dtype == object:
                    vectors.append(Vector(c.dtype, vals, valid))
                else:
                    vectors.append(Vector.from_numpy(vals, c.dtype,
                                                     validity=valid))
            else:
                vectors.append(Vector.nulls(data.num_rows, c.dtype))
        return RecordBatch(schema, vectors)

    def flush(self) -> None:
        for region in self.regions.values():
            region.flush()

    def close(self) -> None:
        for region in self.regions.values():
            region.close()


class MitoEngine(TableEngine):
    name = MITO_ENGINE

    def __init__(self, storage: StorageEngine, state_prefix: str = ""):
        # control state (registry/manifests) is node-scoped when several
        # datanodes share one object store; region DATA stays globally
        # addressed so regions can move between nodes
        self.state_prefix = state_prefix
        self.storage = storage
        self.store = storage.store
        from ..common.locks import TrackedLock
        from ..common.tracking import tracked_state
        self._tables: Dict[tuple, MitoTable] = tracked_state(
            {}, "mito.engine.tables")
        self._lock = TrackedLock("mito.engine")
        self._registry = self._load_registry()

    # ---- engine registry (next id + table dirs) ----
    def _registry_key(self) -> str:
        return f"{self.state_prefix}mito/engine.json"

    def _load_registry(self) -> dict:
        if self.store.exists(self._registry_key()):
            return json.loads(self.store.read(self._registry_key()))
        return {"next_table_id": MIN_USER_TABLE_ID, "tables": {}}

    def _save_registry(self) -> None:
        self.store.write(self._registry_key(),
                         json.dumps(self._registry).encode())

    def _manifest_key(self, catalog: str, schema: str, table_id: int) -> str:
        return (f"{self.state_prefix}mito/{catalog}/{schema}/"
                f"{table_id}/manifest.json")

    # ---- DDL ----
    def create_table(self, request: CreateTableRequest) -> MitoTable:
        key = (request.catalog_name, request.schema_name, request.table_name)
        full = ".".join(key)
        with self._lock:
            existing = self._tables.get(key)
            if existing is None and full in self._registry["tables"]:
                existing = self._open_locked(OpenTableRequest(
                    request.table_name, request.catalog_name,
                    request.schema_name))
            if existing is not None:
                if request.create_if_not_exists:
                    return existing
                raise TableAlreadyExistsError(f"table {full} already exists")
            if request.table_id is not None:
                table_id = request.table_id
                self._registry["next_table_id"] = max(
                    self._registry["next_table_id"], table_id + 1)
            else:
                table_id = self._registry["next_table_id"]
                self._registry["next_table_id"] = table_id + 1

            rule = None
            region_numbers = list(request.region_numbers)
            if request.partitions is not None:
                rule = rule_from_partitions(request.partitions)
                region_numbers = rule.region_numbers()
            elif len(region_numbers) > 1:
                raise InvalidArgumentsError(
                    "multi-region table requires a partition rule")
            if request.assigned_region_numbers is not None:
                # distributed: this datanode materializes (and records in
                # its local manifest) only its assigned regions; the full
                # set lives in the frontend's table route
                bad = set(request.assigned_region_numbers) - \
                    set(region_numbers)
                if bad:
                    raise InvalidArgumentsError(
                        f"assigned regions {sorted(bad)} not in the "
                        f"table's region set {region_numbers}")
                region_numbers = list(request.assigned_region_numbers)
            schema = request.schema
            meta = TableMeta(
                schema=schema,
                primary_key_indices=list(request.primary_key_indices),
                engine=self.name,
                region_numbers=region_numbers,
                next_column_id=len(schema),
                options=dict(request.table_options),
                partition_rule=_serialize_rule(rule),
            )
            info = TableInfo(ident=TableIdent(table_id),
                             name=request.table_name, meta=meta,
                             catalog_name=request.catalog_name,
                             schema_name=request.schema_name,
                             desc=request.desc)
            # manifest first (create recovers from it), then regions
            self.store.write(
                self._manifest_key(*key[:2], table_id),
                json.dumps(info.to_dict()).encode())
            ropts = region_opts_from_table_options(meta.options)
            regions = {rn: self.storage.create_region(
                region_name(table_id, rn), schema, opts=ropts)
                for rn in region_numbers}
            table = MitoTable(info, regions, rule)
            self._tables[key] = table
            self._registry["tables"][full] = table_id
            self._save_registry()
            return table

    def open_table(self, request: OpenTableRequest) -> Optional[MitoTable]:
        with self._lock:
            return self._open_locked(request)

    def _open_locked(self, request: OpenTableRequest) -> Optional[MitoTable]:
        key = (request.catalog_name, request.schema_name, request.table_name)
        if key in self._tables:
            return self._tables[key]
        full = ".".join(key)
        table_id = self._registry["tables"].get(full)
        if table_id is None:
            return None
        raw = self.store.read(self._manifest_key(*key[:2], table_id))
        info = TableInfo.from_dict(json.loads(raw))
        rule = _deserialize_rule(info.meta.partition_rule)
        regions = {}
        ropts = region_opts_from_table_options(info.meta.options)
        for rn in info.meta.region_numbers:
            region = self.storage.open_region(region_name(table_id, rn),
                                              info.meta.schema, opts=ropts)
            if region is None:
                region = self.storage.create_region(
                    region_name(table_id, rn), info.meta.schema, opts=ropts)
            regions[rn] = region
        table = MitoTable(info, regions, rule)
        self._tables[key] = table
        return table

    def alter_table(self, request: AlterTableRequest) -> MitoTable:
        key = (request.catalog_name, request.schema_name, request.table_name)
        with self._lock:
            table = self._open_locked(
                OpenTableRequest(request.table_name, request.catalog_name,
                                 request.schema_name))
            if table is None:
                raise TableNotFoundError(f"table {'.'.join(key)} not found")
            info = table.info
            schema = info.meta.schema
            if request.kind == AlterKind.RENAME_TABLE:
                new_key = key[:2] + (request.new_table_name,)
                full, new_full = ".".join(key), ".".join(new_key)
                if new_full in self._registry["tables"]:
                    raise TableAlreadyExistsError(
                        f"table {new_full} already exists")
                info.name = request.new_table_name
                self._registry["tables"][new_full] = \
                    self._registry["tables"].pop(full)
                del self._tables[key]
                self._tables[new_key] = table
            elif request.kind == AlterKind.ADD_COLUMNS:
                cols = list(schema.column_schemas)
                names = {c.name for c in cols}
                for add in request.add_columns:
                    cs = add.column_schema
                    if cs.name in names:
                        raise ColumnExistsError(
                            f"column {cs.name!r} already exists")
                    if cs.semantic_type != SemanticType.FIELD:
                        # the region series dictionary is immutable (same as
                        # the reference v0.2): new tags/time-index columns
                        # would corrupt existing series encodings
                        raise InvalidArgumentsError(
                            f"only FIELD columns can be added, not "
                            f"{cs.semantic_type.name}")
                    if not cs.nullable and cs.default is None:
                        raise InvalidArgumentsError(
                            f"new column {cs.name!r} must be nullable or "
                            f"have a default")
                    if add.location is None or add.location == "":
                        cols.append(cs)
                    elif add.location == "FIRST":
                        cols.insert(0, cs)
                    else:  # AFTER <col>
                        after = add.location.split(" ", 1)[1]
                        idx = next((i for i, c in enumerate(cols)
                                    if c.name == after), None)
                        if idx is None:
                            raise ColumnNotFoundError(
                                f"column {after!r} not found")
                        cols.insert(idx + 1, cs)
                    names.add(cs.name)
                new_schema = Schema(cols, version=schema.version + 1)
                for region in table.regions.values():
                    region.alter(new_schema)
                info.meta.schema = new_schema
                info.meta.next_column_id = len(cols)
                info.meta.primary_key_indices = [
                    i for i, c in enumerate(cols)
                    if c.semantic_type == SemanticType.TAG]
                info.ident.version += 1
            elif request.kind == AlterKind.DROP_COLUMNS:
                cols = list(schema.column_schemas)
                for name in request.drop_columns:
                    idx = next((i for i, c in enumerate(cols)
                                if c.name == name), None)
                    if idx is None:
                        raise ColumnNotFoundError(f"column {name!r} not found")
                    c = cols[idx]
                    if c.is_time_index or c.is_tag:
                        raise InvalidArgumentsError(
                            f"cannot drop key column {name!r}")
                    cols.pop(idx)
                new_schema = Schema(cols, version=schema.version + 1)
                for region in table.regions.values():
                    region.alter(new_schema)
                info.meta.schema = new_schema
                info.meta.primary_key_indices = [
                    i for i, c in enumerate(cols)
                    if c.semantic_type == SemanticType.TAG]
                info.ident.version += 1
            self.store.write(
                self._manifest_key(info.catalog_name, info.schema_name,
                                   info.ident.table_id),
                json.dumps(info.to_dict()).encode())
            self._save_registry()
            return table

    def drop_table(self, request: DropTableRequest) -> bool:
        key = (request.catalog_name, request.schema_name, request.table_name)
        with self._lock:
            table = self._open_locked(
                OpenTableRequest(request.table_name, request.catalog_name,
                                 request.schema_name))
            if table is None:
                return False
            for rn in table.info.meta.region_numbers:
                self.storage.drop_region(
                    region_name(table.info.ident.table_id, rn))
            self.store.delete(self._manifest_key(
                *key[:2], table.info.ident.table_id))
            self._registry["tables"].pop(".".join(key), None)
            self._tables.pop(key, None)
            self._save_registry()
            return True

    def truncate_table(self, catalog: str, schema: str, name: str) -> bool:
        """Drop + recreate regions, keeping table identity and schema."""
        key = (catalog, schema, name)
        with self._lock:
            table = self._open_locked(OpenTableRequest(name, catalog, schema))
            if table is None:
                return False
            info = table.info
            ropts = region_opts_from_table_options(info.meta.options)
            for rn in list(table.regions):
                rname = region_name(info.ident.table_id, rn)
                self.storage.drop_region(rname)
                table.regions[rn] = self.storage.create_region(
                    rname, info.meta.schema, opts=ropts)
            return True

    def table_exists(self, catalog: str, schema: str, name: str) -> bool:
        with self._lock:
            return ".".join((catalog, schema, name)) in self._registry["tables"]

    def get_table(self, catalog: str, schema: str, name: str
                  ) -> Optional[MitoTable]:
        return self.open_table(OpenTableRequest(name, catalog, schema))

    def table_ids(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._registry["tables"])

    def close(self) -> None:
        with self._lock:
            for table in self._tables.values():
                table.close()
            self._tables.clear()
