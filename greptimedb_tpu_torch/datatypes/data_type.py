"""Concrete data types bridging SQL types, numpy, pyarrow and JAX.

Reference behavior: src/datatypes/src/data_type.rs — `ConcreteDataType`
enumerates the storable types (bool, int/uint 8-64, float 32/64, string,
binary, date, timestamps at 4 units) and knows its Arrow mapping. Here each
type additionally knows its numpy dtype (host SoA buffers) and its device
dtype (what the column looks like in HBM; strings are dictionary-encoded to
int32 tag ids before they ever reach the device).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import pyarrow as pa

from ..common.time import TimeUnit


@dataclass(frozen=True)
class ConcreteDataType:
    name: str
    np_dtype: Optional[np.dtype]  # None for string/binary (object arrays host-side)
    pa_type: pa.DataType = field(compare=False)
    time_unit: Optional[TimeUnit] = None

    # ---- classification ----
    @property
    def is_timestamp(self) -> bool:
        return self.time_unit is not None

    @property
    def is_string(self) -> bool:
        return self.name == "String"

    @property
    def is_binary(self) -> bool:
        return self.name == "Binary"

    @property
    def is_numeric(self) -> bool:
        return self.np_dtype is not None and np.issubdtype(self.np_dtype, np.number) \
            and not self.is_timestamp

    @property
    def is_float(self) -> bool:
        return self.np_dtype is not None and np.issubdtype(self.np_dtype, np.floating)

    @property
    def is_boolean(self) -> bool:
        return self.name == "Boolean"

    # ---- device mapping ----
    def device_np_dtype(self) -> np.dtype:
        """Dtype of this column once resident on device. Strings/binary are
        dictionary ids (int32); timestamps are int64 ticks; bools are int8."""
        if self.is_string or self.is_binary:
            return np.dtype(np.int32)
        if self.is_timestamp:
            return np.dtype(np.int64)
        if self.is_boolean:
            return np.dtype(np.int8)
        assert self.np_dtype is not None
        return self.np_dtype

    def default_value(self) -> Any:
        if self.is_string:
            return ""
        if self.is_binary:
            return b""
        if self.is_boolean:
            return False
        if self.is_float:
            return 0.0
        return 0

    def cast_value(self, v: Any) -> Any:
        """Cast a python value into this type's canonical python repr."""
        if v is None:
            return None
        if self.is_string:
            return str(v)
        if self.is_binary:
            return bytes(v)
        if self.is_boolean:
            if isinstance(v, str):
                return v.lower() in ("true", "1", "t", "yes")
            return bool(v)
        if self.is_timestamp:
            from ..common.time import Timestamp
            if isinstance(v, Timestamp):
                return v.convert_to(self.time_unit).value
            if isinstance(v, str):
                return Timestamp.from_str(v, self.time_unit).value
            return int(v)
        if self.is_float:
            return float(v)
        return int(v)

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.name


def _ts_patype(unit: TimeUnit) -> pa.DataType:
    return pa.timestamp(unit.value)


BOOLEAN = ConcreteDataType("Boolean", np.dtype(np.bool_), pa.bool_())
INT8 = ConcreteDataType("Int8", np.dtype(np.int8), pa.int8())
INT16 = ConcreteDataType("Int16", np.dtype(np.int16), pa.int16())
INT32 = ConcreteDataType("Int32", np.dtype(np.int32), pa.int32())
INT64 = ConcreteDataType("Int64", np.dtype(np.int64), pa.int64())
UINT8 = ConcreteDataType("UInt8", np.dtype(np.uint8), pa.uint8())
UINT16 = ConcreteDataType("UInt16", np.dtype(np.uint16), pa.uint16())
UINT32 = ConcreteDataType("UInt32", np.dtype(np.uint32), pa.uint32())
UINT64 = ConcreteDataType("UInt64", np.dtype(np.uint64), pa.uint64())
FLOAT32 = ConcreteDataType("Float32", np.dtype(np.float32), pa.float32())
FLOAT64 = ConcreteDataType("Float64", np.dtype(np.float64), pa.float64())
STRING = ConcreteDataType("String", None, pa.string())
BINARY = ConcreteDataType("Binary", None, pa.binary())
DATE = ConcreteDataType("Date", np.dtype(np.int32), pa.date32())
TIMESTAMP_SECOND = ConcreteDataType(
    "TimestampSecond", np.dtype(np.int64), _ts_patype(TimeUnit.SECOND), TimeUnit.SECOND)
TIMESTAMP_MILLISECOND = ConcreteDataType(
    "TimestampMillisecond", np.dtype(np.int64), _ts_patype(TimeUnit.MILLISECOND),
    TimeUnit.MILLISECOND)
TIMESTAMP_MICROSECOND = ConcreteDataType(
    "TimestampMicrosecond", np.dtype(np.int64), _ts_patype(TimeUnit.MICROSECOND),
    TimeUnit.MICROSECOND)
TIMESTAMP_NANOSECOND = ConcreteDataType(
    "TimestampNanosecond", np.dtype(np.int64), _ts_patype(TimeUnit.NANOSECOND),
    TimeUnit.NANOSECOND)

_TS_BY_UNIT = {
    TimeUnit.SECOND: TIMESTAMP_SECOND,
    TimeUnit.MILLISECOND: TIMESTAMP_MILLISECOND,
    TimeUnit.MICROSECOND: TIMESTAMP_MICROSECOND,
    TimeUnit.NANOSECOND: TIMESTAMP_NANOSECOND,
}


def timestamp_type(unit: TimeUnit) -> ConcreteDataType:
    return _TS_BY_UNIT[unit]


ALL_TYPES = [
    BOOLEAN, INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64,
    FLOAT32, FLOAT64, STRING, BINARY, DATE,
    TIMESTAMP_SECOND, TIMESTAMP_MILLISECOND, TIMESTAMP_MICROSECOND,
    TIMESTAMP_NANOSECOND,
]

_BY_NAME = {t.name.lower(): t for t in ALL_TYPES}

# SQL-facing aliases (CREATE TABLE type names).
_SQL_ALIASES = {
    "bool": BOOLEAN, "boolean": BOOLEAN,
    "tinyint": INT8, "int8": INT8,
    "smallint": INT16, "int16": INT16,
    "int": INT32, "integer": INT32, "int32": INT32,
    "bigint": INT64, "int64": INT64,
    "tinyint unsigned": UINT8, "uint8": UINT8,
    "smallint unsigned": UINT16, "uint16": UINT16,
    "int unsigned": UINT32, "uint32": UINT32,
    "bigint unsigned": UINT64, "uint64": UINT64,
    "float": FLOAT32, "float32": FLOAT32, "real": FLOAT32,
    "double": FLOAT64, "float64": FLOAT64,
    "string": STRING, "text": STRING, "varchar": STRING, "char": STRING,
    "binary": BINARY, "varbinary": BINARY, "blob": BINARY, "bytea": BINARY,
    "date": DATE,
    "timestamp": TIMESTAMP_MILLISECOND,
    "timestamp_s": TIMESTAMP_SECOND, "timestamp(0)": TIMESTAMP_SECOND,
    "timestamp_ms": TIMESTAMP_MILLISECOND, "timestamp(3)": TIMESTAMP_MILLISECOND,
    "timestamp_us": TIMESTAMP_MICROSECOND, "timestamp(6)": TIMESTAMP_MICROSECOND,
    "timestamp_ns": TIMESTAMP_NANOSECOND, "timestamp(9)": TIMESTAMP_NANOSECOND,
    "datetime": TIMESTAMP_MILLISECOND,
}


def parse_type_name(name: str) -> ConcreteDataType:
    key = " ".join(name.strip().lower().split())
    if key in _SQL_ALIASES:
        return _SQL_ALIASES[key]
    if key in _BY_NAME:
        return _BY_NAME[key]
    raise ValueError(f"unknown data type: {name!r}")


def from_arrow_type(t: pa.DataType) -> ConcreteDataType:
    if pa.types.is_timestamp(t):
        unit = {"s": TimeUnit.SECOND, "ms": TimeUnit.MILLISECOND,
                "us": TimeUnit.MICROSECOND, "ns": TimeUnit.NANOSECOND}[t.unit]
        return timestamp_type(unit)
    for c in ALL_TYPES:
        if c.pa_type.equals(t):
            return c
    if pa.types.is_large_string(t) or pa.types.is_string_view(t):
        return STRING
    if pa.types.is_large_binary(t):
        return BINARY
    if pa.types.is_dictionary(t):
        return from_arrow_type(t.value_type)
    raise ValueError(f"unsupported arrow type: {t}")
