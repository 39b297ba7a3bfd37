"""Immutable file table engine implementation.

Reference mapping: engine create/open/drop with per-table JSON manifest
(src/file-table-engine/src/engine/immutable.rs:100-310,
manifest.rs), format readers (src/file-table-engine/src/table/format.rs;
CSV/JSON/Parquet via common-datasource). Schema comes from the CREATE
statement or, when no columns are declared, is inferred from the file.

Copied from greptimedb_tpu/file_table/engine.py: the manifest keys
(`file_tables/<catalog>/<schema>/<name>.json`) and the manifest document
are the reference's, so either package reopens the other's external
tables from a shared data home. A scan reads the file on the host; a
query over an external table takes the query engine's host path, as in
the reference.
"""

from __future__ import annotations

import io
import json
import threading
from typing import Dict, List, Optional, Sequence

import pyarrow as pa
import pyarrow.csv as pa_csv
import pyarrow.json as pa_json
import pyarrow.parquet as pq

from ..datatypes.record_batch import RecordBatch
from ..datatypes.schema import Schema
from ..errors import (
    InvalidArgumentsError, TableAlreadyExistsError, UnsupportedError)
from ..table.metadata import TableIdent, TableInfo, TableMeta
from ..table.table import Table, TableEngine

ENGINE_NAME = "file"
MANIFEST_DIR = "file_tables"


class ImmutableFileTable(Table):
    def __init__(self, info: TableInfo, store, location: str, fmt: str):
        super().__init__(info)
        self.store = store
        self.location = location
        self.format = fmt

    def _read_arrow(self) -> pa.Table:
        from ..common.datasource import file_codec
        data = self.store.read(self.location)
        codec = file_codec(self.location,
                           self.info.meta.options.get("compression")
                           if self.info.meta.options else None)
        if codec is not None and self.format != "parquet":
            data = pa.CompressedInputStream(
                pa.BufferReader(data), codec).read()
        if self.format == "parquet":
            return pq.read_table(io.BytesIO(data))
        if self.format == "csv":
            return pa_csv.read_csv(io.BytesIO(data))
        if self.format == "json":
            return pa_json.read_json(io.BytesIO(data))
        raise UnsupportedError(f"external table format {self.format!r}")

    def scan_batches(self, projection: Optional[Sequence[str]] = None,
                     time_range=None, limit: Optional[int] = None
                     ) -> List[RecordBatch]:
        at = self._read_arrow()
        schema = self.schema
        # align file columns to the declared schema (by name); missing
        # declared columns surface as an error, extra file columns drop
        names = list(schema.names()) if len(schema) else at.schema.names
        cols = []
        for n in names:
            if n not in at.schema.names:
                raise InvalidArgumentsError(
                    f"external file lacks column {n!r}")
            cols.append(at.column(n))
        at = pa.table(dict(zip(names, cols)))
        if len(schema):
            at = at.cast(schema.to_arrow())
        if projection is not None:
            at = at.select(list(projection))
        if limit is not None:
            at = at.slice(0, limit)
        batch_schema = Schema.from_arrow(at.schema) if not len(schema) \
            else (schema if projection is None
                  else schema.project(list(projection)))
        out = []
        for rb in at.combine_chunks().to_batches():
            out.append(RecordBatch.from_arrow(rb, batch_schema))
        if not out:
            out.append(RecordBatch.empty(batch_schema))
        return out


class ImmutableFileTableEngine(TableEngine):
    name = ENGINE_NAME

    def __init__(self, store, state_prefix: str = ""):
        self.store = store
        self._prefix = state_prefix
        self._tables: Dict[tuple, ImmutableFileTable] = {}
        self._lock = threading.Lock()
        self._next_id = 2_000_000          # distinct id space from mito

    def _manifest_key(self, catalog: str, schema: str, name: str) -> str:
        return f"{self._prefix}{MANIFEST_DIR}/{catalog}/{schema}/{name}.json"

    # ---- TableEngine ----
    def create_table(self, request) -> Table:
        opts = {k.lower(): v for k, v in request.table_options.items()}
        location = opts.get("location")
        if not location:
            raise InvalidArgumentsError(
                "external table needs WITH (location='...')")
        fmt = str(opts.get("format", _infer_format(location))).lower()
        key = (request.catalog_name, request.schema_name,
               request.table_name)
        with self._lock:
            if key in self._tables:
                if request.create_if_not_exists:
                    return self._tables[key]
                raise TableAlreadyExistsError(
                    f"external table {request.table_name!r} exists")
            table_id = request.table_id or self._next_id
            self._next_id = max(self._next_id + 1, table_id + 1)

        schema = request.schema
        if not len(schema):
            # schema inference from the file itself
            probe = ImmutableFileTable(
                TableInfo(TableIdent(table_id), request.table_name,
                          TableMeta(schema=schema, engine=self.name),
                          request.catalog_name, request.schema_name),
                self.store, location, fmt)
            arrow = probe._read_arrow()
            schema = Schema.from_arrow(arrow.schema)

        info = TableInfo(
            ident=TableIdent(table_id), name=request.table_name,
            meta=TableMeta(schema=schema,
                           primary_key_indices=list(
                               request.primary_key_indices),
                           engine=self.name,
                           region_numbers=[],
                           next_column_id=len(schema),
                           options={"location": location, "format": fmt,
                                    **({"compression": opts["compression"]}
                                       if "compression" in opts else {})}),
            catalog_name=request.catalog_name,
            schema_name=request.schema_name)
        self.store.write(self._manifest_key(*key),
                         json.dumps(info.to_dict()).encode())
        table = ImmutableFileTable(info, self.store, location, fmt)
        with self._lock:
            self._tables[key] = table
        return table

    def open_table(self, request) -> Optional[Table]:
        key = (request.catalog_name, request.schema_name,
               request.table_name)
        with self._lock:
            if key in self._tables:
                return self._tables[key]
        mkey = self._manifest_key(*key)
        if not self.store.exists(mkey):
            return None
        info = TableInfo.from_dict(json.loads(self.store.read(mkey)))
        table = ImmutableFileTable(
            info, self.store, info.meta.options["location"],
            info.meta.options["format"])
        with self._lock:
            self._tables[key] = table
        return table

    def alter_table(self, request) -> Table:
        raise UnsupportedError("external file tables are immutable")

    def drop_table(self, request) -> bool:
        key = (request.catalog_name, request.schema_name,
               request.table_name)
        with self._lock:
            existed = self._tables.pop(key, None) is not None
        mkey = self._manifest_key(*key)
        on_disk = self.store.exists(mkey)
        self.store.delete(mkey)            # data file is NOT ours to drop
        return existed or on_disk

    def truncate_table(self, catalog, schema, name) -> bool:
        raise UnsupportedError("external file tables are immutable")

    def table_exists(self, catalog, schema, name) -> bool:
        with self._lock:
            if (catalog, schema, name) in self._tables:
                return True
        return self.store.exists(self._manifest_key(catalog, schema, name))

    def get_table(self, catalog, schema, name) -> Optional[Table]:
        with self._lock:
            return self._tables.get((catalog, schema, name))


def _infer_format(location: str) -> str:
    base = location
    for cext in (".gz", ".gzip", ".zst", ".zstd"):
        if base.lower().endswith(cext):
            base = base[:-len(cext)]
            break
    for ext, fmt in ((".parquet", "parquet"), (".csv", "csv"),
                     (".json", "json"), (".ndjson", "json")):
        if base.endswith(ext):
            return fmt
    raise InvalidArgumentsError(
        f"cannot infer format from {location!r}; pass WITH (format=...)")
