"""The Table and TableEngine interfaces.

Reference behavior: src/table/src/table.rs:36-122 (`Table`:
schema/scan/insert/delete/alter/flush/close) and src/table/src/engine.rs:64
(`TableEngine`: create/open/alter/drop/exists). Scans come in two shapes:

- `scan_batches` — generic RecordBatch output every table supports (the
  DataFusion TableProvider analog; CPU/protocol paths consume it);
- `scan_raw` — the TPU fast path: per-region SoA arrays + series dictionary
  that the query engine feeds straight to the device kernels. Only the mito
  engine implements it; callers must fall back to `scan_batches` when it
  returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..common.time import TimestampRange
from ..datatypes.record_batch import RecordBatch
from ..datatypes.schema import Schema
from ..errors import UnsupportedError
from .metadata import TableInfo
from .requests import AlterTableRequest


class Table:
    def __init__(self, info: TableInfo):
        self._info = info

    @property
    def info(self) -> TableInfo:
        return self._info

    @property
    def schema(self) -> Schema:
        return self._info.meta.schema

    @property
    def name(self) -> str:
        return self._info.name

    def scan_batches(self, projection: Optional[Sequence[str]] = None,
                     time_range: Optional[TimestampRange] = None,
                     limit: Optional[int] = None) -> List[RecordBatch]:
        raise NotImplementedError

    def scan_raw(self, projection: Optional[Sequence[str]] = None,
                 time_range: Optional[TimestampRange] = None):
        """TPU fast path: list of per-region storage ScanData, or None if
        this table has no SoA representation."""
        return None

    def insert(self, columns: Dict[str, Sequence]) -> int:
        raise UnsupportedError(f"table {self.name} does not support insert")

    def delete(self, key_columns: Dict[str, Sequence]) -> int:
        raise UnsupportedError(f"table {self.name} does not support delete")

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class TableEngine:
    name: str = "base"

    def create_table(self, request) -> Table:
        raise NotImplementedError

    def open_table(self, request) -> Optional[Table]:
        raise NotImplementedError

    def alter_table(self, request: AlterTableRequest) -> Table:
        raise NotImplementedError

    def drop_table(self, request) -> bool:
        raise NotImplementedError

    def truncate_table(self, catalog: str, schema: str, name: str) -> bool:
        raise NotImplementedError

    def table_exists(self, catalog: str, schema: str, name: str) -> bool:
        raise NotImplementedError

    def get_table(self, catalog: str, schema: str, name: str) -> Optional[Table]:
        raise NotImplementedError

    def close(self) -> None:
        pass
