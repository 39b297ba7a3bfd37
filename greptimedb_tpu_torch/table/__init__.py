"""Table abstraction layer.

Reference behavior: src/table — the `Table` trait
(src/table/src/table.rs:36-122: schema/scan/insert/delete/alter/flush),
`TableEngine` (src/table/src/engine.rs:64), `TableInfo`/`TableMeta`
(src/table/src/metadata.rs), and the `NumbersTable` test fixture
(src/table/src/table/numbers.rs).
"""

from .metadata import TableIdent, TableInfo, TableMeta, TableType
from .requests import (
    AddColumnRequest,
    AlterKind,
    AlterTableRequest,
    CreateTableRequest,
    DeleteRequest,
    DropTableRequest,
    InsertRequest,
    OpenTableRequest,
)
from .table import Table, TableEngine
from .numbers import NumbersTable

__all__ = [
    "Table", "TableEngine", "TableIdent", "TableInfo", "TableMeta",
    "TableType", "CreateTableRequest", "OpenTableRequest",
    "AlterTableRequest", "AlterKind", "AddColumnRequest", "DropTableRequest",
    "InsertRequest", "DeleteRequest", "NumbersTable",
]
