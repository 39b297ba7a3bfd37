"""Schemas with TIME INDEX and primary-key (tag) semantics.

Reference behavior: src/datatypes/src/schema/ — `ColumnSchema` carries name,
type, nullability, default constraint and a timestamp-index flag; `Schema`
carries the ordered columns plus the timestamp index and a version used for
read-compat across ALTERs. Semantic types (TAG/TIMESTAMP/FIELD) follow the
time-series model of the mito engine (src/storage/src/metadata.rs).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import pyarrow as pa

from .data_type import ConcreteDataType, from_arrow_type, parse_type_name
from .vector import Vector


class SemanticType(enum.Enum):
    TAG = "TAG"            # member of the primary key
    TIMESTAMP = "TIMESTAMP"  # the TIME INDEX column
    FIELD = "FIELD"


@dataclass(frozen=True)
class ColumnDefaultConstraint:
    """Either a constant value or the function 'current_timestamp()'."""

    value: Any = None
    function: Optional[str] = None  # e.g. "current_timestamp"

    def resolve(self, dtype: ConcreteDataType, now_ms: Optional[int] = None) -> Any:
        if self.function is not None:
            fn = self.function.lower().rstrip("()")
            if fn in ("current_timestamp", "now"):
                import time as _t
                ms = now_ms if now_ms is not None else int(_t.time() * 1000)
                if dtype.is_timestamp:
                    from ..common.time import Timestamp, TimeUnit
                    return Timestamp(ms, TimeUnit.MILLISECOND).convert_to(dtype.time_unit).value
                return ms
            raise ValueError(f"unsupported default function {self.function!r}")
        if self.value is None:
            return None
        return dtype.cast_value(self.value)


@dataclass
class ColumnSchema:
    name: str
    dtype: ConcreteDataType
    nullable: bool = True
    semantic_type: SemanticType = SemanticType.FIELD
    default: Optional[ColumnDefaultConstraint] = None
    comment: str = ""

    @property
    def is_time_index(self) -> bool:
        return self.semantic_type == SemanticType.TIMESTAMP

    @property
    def is_tag(self) -> bool:
        return self.semantic_type == SemanticType.TAG

    def create_default_vector(self, n: int) -> Optional[Vector]:
        """Vector used to fill this column when an INSERT omits it."""
        if self.default is not None:
            v = self.default.resolve(self.dtype)
            return Vector.constant(v, n, self.dtype)
        if self.nullable:
            return Vector.nulls(n, self.dtype)
        return None

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "type": self.dtype.name,
            "nullable": self.nullable,
            "semantic_type": self.semantic_type.value,
        }
        if self.default is not None:
            d["default"] = {"value": self.default.value, "function": self.default.function}
        if self.comment:
            d["comment"] = self.comment
        return d

    @staticmethod
    def from_dict(d: dict) -> "ColumnSchema":
        default = None
        if d.get("default") is not None:
            default = ColumnDefaultConstraint(
                value=d["default"].get("value"), function=d["default"].get("function"))
        return ColumnSchema(
            name=d["name"],
            dtype=parse_type_name(d["type"]),
            nullable=d.get("nullable", True),
            semantic_type=SemanticType(d.get("semantic_type", "FIELD")),
            default=default,
            comment=d.get("comment", ""),
        )


class Schema:
    """Ordered column schemas + time index + version."""

    def __init__(self, column_schemas: Sequence[ColumnSchema], version: int = 0):
        self.column_schemas: List[ColumnSchema] = list(column_schemas)
        self.version = version
        self._index: Dict[str, int] = {c.name: i for i, c in enumerate(self.column_schemas)}
        ts = [i for i, c in enumerate(self.column_schemas) if c.is_time_index]
        if len(ts) > 1:
            raise ValueError("multiple TIME INDEX columns")
        self.timestamp_index: Optional[int] = ts[0] if ts else None
        if self.timestamp_index is not None:
            tc = self.column_schemas[self.timestamp_index]
            if tc.nullable:
                raise ValueError(
                    f"TIME INDEX column {tc.name!r} must be non-nullable")
            if not tc.dtype.is_timestamp:
                raise ValueError(
                    f"TIME INDEX column {tc.name!r} must be a timestamp type")

    # ---- access ----
    def __len__(self) -> int:
        return len(self.column_schemas)

    def names(self) -> List[str]:
        return [c.name for c in self.column_schemas]

    def column_index(self, name: str) -> int:
        if name not in self._index:
            raise KeyError(name)
        return self._index[name]

    def contains(self, name: str) -> bool:
        return name in self._index

    def column_schema(self, name: str) -> ColumnSchema:
        return self.column_schemas[self.column_index(name)]

    @property
    def timestamp_column(self) -> Optional[ColumnSchema]:
        if self.timestamp_index is None:
            return None
        return self.column_schemas[self.timestamp_index]

    def tag_columns(self) -> List[ColumnSchema]:
        return [c for c in self.column_schemas if c.is_tag]

    def field_columns(self) -> List[ColumnSchema]:
        return [c for c in self.column_schemas
                if c.semantic_type == SemanticType.FIELD]

    def tag_names(self) -> List[str]:
        return [c.name for c in self.tag_columns()]

    def field_names(self) -> List[str]:
        return [c.name for c in self.field_columns()]

    def project(self, names: Sequence[str]) -> "Schema":
        return Schema([self.column_schema(n) for n in names], self.version)

    # ---- interop ----
    def to_arrow(self) -> pa.Schema:
        fields = []
        for c in self.column_schemas:
            meta = {b"semantic_type": c.semantic_type.value.encode()}
            fields.append(pa.field(c.name, c.dtype.pa_type, nullable=c.nullable,
                                   metadata=meta))
        return pa.schema(fields, metadata={b"greptime:version": str(self.version).encode()})

    @staticmethod
    def from_arrow(s: pa.Schema) -> "Schema":
        cols = []
        for f in s:
            sem = SemanticType.FIELD
            if f.metadata and b"semantic_type" in f.metadata:
                sem = SemanticType(f.metadata[b"semantic_type"].decode())
            cols.append(ColumnSchema(f.name, from_arrow_type(f.type),
                                     nullable=f.nullable, semantic_type=sem))
        version = 0
        if s.metadata and b"greptime:version" in s.metadata:
            version = int(s.metadata[b"greptime:version"])
        return Schema(cols, version)

    def to_dict(self) -> dict:
        return {"version": self.version,
                "columns": [c.to_dict() for c in self.column_schemas]}

    @staticmethod
    def from_dict(d: dict) -> "Schema":
        return Schema([ColumnSchema.from_dict(c) for c in d["columns"]],
                      version=d.get("version", 0))

    def __eq__(self, other) -> bool:
        if not isinstance(other, Schema):
            return NotImplemented
        return self.to_dict() == other.to_dict()

    def __repr__(self) -> str:  # pragma: no cover
        cols = ", ".join(f"{c.name}:{c.dtype.name}" for c in self.column_schemas)
        return f"Schema[v{self.version}]({cols})"
