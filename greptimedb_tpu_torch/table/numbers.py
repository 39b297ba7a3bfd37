"""NumbersTable test fixture: a read-only table of 0..99.

Reference behavior: src/table/src/table/numbers.rs:177 — used across the
reference's query tests (`SELECT * FROM numbers`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..datatypes import data_type as dt
from ..datatypes.record_batch import RecordBatch
from ..datatypes.schema import ColumnSchema, Schema, SemanticType
from .metadata import TableIdent, TableInfo, TableMeta, TableType
from .table import Table

NUMBERS_TABLE_ID = 2


class NumbersTable(Table):
    def __init__(self, count: int = 100):
        schema = Schema([ColumnSchema("number", dt.UINT32, nullable=False,
                                      semantic_type=SemanticType.FIELD)])
        info = TableInfo(
            ident=TableIdent(NUMBERS_TABLE_ID),
            name="numbers",
            meta=TableMeta(schema=schema, engine="test"),
            table_type=TableType.TEMPORARY,
        )
        super().__init__(info)
        self._count = count

    def scan_batches(self, projection: Optional[Sequence[str]] = None,
                     time_range=None, limit: Optional[int] = None
                     ) -> List[RecordBatch]:
        n = self._count if limit is None else min(self._count, limit)
        schema = self.schema if projection is None \
            else self.schema.project(projection)
        if projection is not None and "number" not in projection:
            return [RecordBatch.empty(schema)]
        return [RecordBatch.from_pydict(
            schema, {"number": np.arange(n, dtype=np.uint32)})]
