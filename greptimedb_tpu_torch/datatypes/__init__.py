from .data_type import (  # noqa: F401
    ConcreteDataType,
    BOOLEAN, INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64,
    FLOAT32, FLOAT64, STRING, BINARY, DATE,
    TIMESTAMP_SECOND, TIMESTAMP_MILLISECOND, TIMESTAMP_MICROSECOND,
    TIMESTAMP_NANOSECOND, timestamp_type, parse_type_name,
)
from .vector import Vector  # noqa: F401
from .schema import ColumnSchema, Schema, SemanticType, ColumnDefaultConstraint  # noqa: F401
from .record_batch import RecordBatch  # noqa: F401
