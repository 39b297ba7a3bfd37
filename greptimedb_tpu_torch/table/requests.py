"""Table engine request types.

Reference behavior: src/table/src/requests.rs — Create/Open/Alter/Drop/
Insert/Delete request structs handed to a `TableEngine`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from ..datatypes.schema import ColumnSchema, Schema
from .. import DEFAULT_CATALOG_NAME, DEFAULT_SCHEMA_NAME


@dataclass
class CreateTableRequest:
    table_name: str
    schema: Schema
    catalog_name: str = DEFAULT_CATALOG_NAME
    schema_name: str = DEFAULT_SCHEMA_NAME
    desc: Optional[str] = None
    primary_key_indices: List[int] = field(default_factory=list)
    create_if_not_exists: bool = False
    region_numbers: List[int] = field(default_factory=lambda: [0])
    table_options: Dict[str, Any] = field(default_factory=dict)
    partitions: Optional[object] = None      # sql.ast.Partitions
    table_id: Optional[int] = None           # pre-allocated (distributed)
    # distributed: this datanode materializes only these regions (the
    # full region set stays in table metadata for routing/splitting)
    assigned_region_numbers: Optional[List[int]] = None


@dataclass
class OpenTableRequest:
    table_name: str
    catalog_name: str = DEFAULT_CATALOG_NAME
    schema_name: str = DEFAULT_SCHEMA_NAME
    table_id: Optional[int] = None
    region_numbers: Optional[List[int]] = None


class AlterKind(enum.Enum):
    ADD_COLUMNS = "add_columns"
    DROP_COLUMNS = "drop_columns"
    RENAME_TABLE = "rename_table"


@dataclass
class AddColumnRequest:
    column_schema: ColumnSchema
    is_key: bool = False
    location: Optional[str] = None           # FIRST / AFTER <col>


@dataclass
class AlterTableRequest:
    table_name: str
    kind: AlterKind
    catalog_name: str = DEFAULT_CATALOG_NAME
    schema_name: str = DEFAULT_SCHEMA_NAME
    add_columns: List[AddColumnRequest] = field(default_factory=list)
    drop_columns: List[str] = field(default_factory=list)
    new_table_name: Optional[str] = None


@dataclass
class DropTableRequest:
    table_name: str
    catalog_name: str = DEFAULT_CATALOG_NAME
    schema_name: str = DEFAULT_SCHEMA_NAME


@dataclass
class InsertRequest:
    table_name: str
    columns: Dict[str, Sequence]
    catalog_name: str = DEFAULT_CATALOG_NAME
    schema_name: str = DEFAULT_SCHEMA_NAME


@dataclass
class DeleteRequest:
    table_name: str
    key_columns: Dict[str, Sequence]
    catalog_name: str = DEFAULT_CATALOG_NAME
    schema_name: str = DEFAULT_SCHEMA_NAME


def create_request_to_dict(req: CreateTableRequest) -> dict:
    """JSON-safe codec shared by the Flight DDL plane and the durable
    procedure store (both ship CreateTableRequest across a boundary)."""
    parts = None
    if req.partitions is not None:
        parts = {"columns": list(req.partitions.columns),
                 "entries": [{"name": e.name, "values": list(e.values)}
                             for e in req.partitions.entries],
                 "kind": getattr(req.partitions, "kind", "range"),
                 "num_partitions": getattr(req.partitions,
                                           "num_partitions", None)}
    return {
        "table_name": req.table_name,
        "schema": req.schema.to_dict(),
        "catalog_name": req.catalog_name,
        "schema_name": req.schema_name,
        "desc": req.desc,
        "primary_key_indices": list(req.primary_key_indices),
        "create_if_not_exists": req.create_if_not_exists,
        "region_numbers": list(req.region_numbers),
        "table_options": dict(req.table_options),
        "partitions": parts,
        "table_id": req.table_id,
        "assigned_region_numbers": req.assigned_region_numbers,
    }


def create_request_from_dict(d: dict) -> CreateTableRequest:
    from ..sql.ast import PartitionEntry, Partitions
    parts = None
    if d.get("partitions") is not None:
        p = d["partitions"]
        parts = Partitions(
            columns=list(p["columns"]),
            entries=[PartitionEntry(e["name"], list(e["values"]))
                     for e in p["entries"]],
            kind=p.get("kind", "range"),
            num_partitions=p.get("num_partitions"))
    return CreateTableRequest(
        table_name=d["table_name"],
        schema=Schema.from_dict(d["schema"]),
        catalog_name=d["catalog_name"],
        schema_name=d["schema_name"],
        desc=d.get("desc"),
        primary_key_indices=list(d["primary_key_indices"]),
        create_if_not_exists=d["create_if_not_exists"],
        region_numbers=list(d["region_numbers"]),
        table_options=dict(d["table_options"]),
        partitions=parts,
        table_id=d.get("table_id"),
        assigned_region_numbers=d.get("assigned_region_numbers"),
    )


def alter_request_to_dict(r: AlterTableRequest) -> dict:
    return {"table_name": r.table_name, "kind": r.kind.value,
            "catalog_name": r.catalog_name, "schema_name": r.schema_name,
            "drop_columns": list(r.drop_columns),
            "new_table_name": r.new_table_name,
            "add_columns": [
                {"column": a.column_schema.to_dict(), "is_key": a.is_key,
                 "location": a.location} for a in r.add_columns]}


def alter_request_from_dict(d: dict) -> AlterTableRequest:
    return AlterTableRequest(
        d["table_name"], AlterKind(d["kind"]),
        catalog_name=d["catalog_name"], schema_name=d["schema_name"],
        add_columns=[AddColumnRequest(
            ColumnSchema.from_dict(a["column"]), a["is_key"],
            a["location"]) for a in d["add_columns"]],
        drop_columns=list(d["drop_columns"]),
        new_table_name=d["new_table_name"])
