"""Table metadata: TableMeta / TableInfo / idents.

Reference behavior: src/table/src/metadata.rs:801 — `TableMeta` carries the
schema + primary key indices + engine + region numbers + options;
`TableInfo` adds identity (id, version), names and table type.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..datatypes.schema import Schema
from .. import DEFAULT_CATALOG_NAME, DEFAULT_SCHEMA_NAME, MITO_ENGINE


class TableType(enum.Enum):
    BASE = "base"
    VIEW = "view"
    TEMPORARY = "temporary"


@dataclass
class TableIdent:
    table_id: int
    version: int = 0


@dataclass
class TableMeta:
    schema: Schema
    primary_key_indices: List[int] = field(default_factory=list)
    engine: str = MITO_ENGINE
    region_numbers: List[int] = field(default_factory=lambda: [0])
    next_column_id: int = 0
    options: Dict[str, object] = field(default_factory=dict)
    created_on_ms: int = field(default_factory=lambda: int(time.time() * 1000))
    partition_rule: Optional[dict] = None   # serialized partition rule

    @property
    def primary_key_names(self) -> List[str]:
        names = self.schema.names()
        return [names[i] for i in self.primary_key_indices]

    def value_indices(self) -> List[int]:
        pk = set(self.primary_key_indices)
        ts = None
        tc = self.schema.timestamp_column
        if tc is not None:
            ts = self.schema.column_index(tc.name)
        return [i for i in range(len(self.schema))
                if i not in pk and i != ts]

    def to_dict(self) -> dict:
        return {
            "schema": self.schema.to_dict(),
            "primary_key_indices": self.primary_key_indices,
            "engine": self.engine,
            "region_numbers": self.region_numbers,
            "next_column_id": self.next_column_id,
            "options": self.options,
            "created_on_ms": self.created_on_ms,
            "partition_rule": self.partition_rule,
        }

    @staticmethod
    def from_dict(d: dict) -> "TableMeta":
        return TableMeta(
            schema=Schema.from_dict(d["schema"]),
            primary_key_indices=list(d.get("primary_key_indices", [])),
            engine=d.get("engine", MITO_ENGINE),
            region_numbers=list(d.get("region_numbers", [0])),
            next_column_id=d.get("next_column_id", 0),
            options=dict(d.get("options", {})),
            created_on_ms=d.get("created_on_ms", 0),
            partition_rule=d.get("partition_rule"),
        )


@dataclass
class TableInfo:
    ident: TableIdent
    name: str
    meta: TableMeta
    catalog_name: str = DEFAULT_CATALOG_NAME
    schema_name: str = DEFAULT_SCHEMA_NAME
    desc: Optional[str] = None
    table_type: TableType = TableType.BASE

    @property
    def full_name(self) -> str:
        return f"{self.catalog_name}.{self.schema_name}.{self.name}"

    def to_dict(self) -> dict:
        return {
            "table_id": self.ident.table_id,
            "version": self.ident.version,
            "name": self.name,
            "catalog_name": self.catalog_name,
            "schema_name": self.schema_name,
            "desc": self.desc,
            "table_type": self.table_type.value,
            "meta": self.meta.to_dict(),
        }

    @staticmethod
    def from_dict(d: dict) -> "TableInfo":
        return TableInfo(
            ident=TableIdent(d["table_id"], d.get("version", 0)),
            name=d["name"],
            catalog_name=d.get("catalog_name", DEFAULT_CATALOG_NAME),
            schema_name=d.get("schema_name", DEFAULT_SCHEMA_NAME),
            desc=d.get("desc"),
            table_type=TableType(d.get("table_type", "base")),
            meta=TableMeta.from_dict(d["meta"]),
        )
