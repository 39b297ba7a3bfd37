"""Table abstraction layer.

Reference behavior: src/table — the `Table` trait
(src/table/src/table.rs:36-122), `TableEngine`
(src/table/src/engine.rs:64) and `TableInfo`/`TableMeta`
(src/table/src/metadata.rs). Region-backed tables come with the storage
slice.
"""

from .metadata import TableIdent, TableInfo, TableMeta, TableType
from .table import Table, TableEngine

__all__ = ["Table", "TableEngine", "TableIdent", "TableInfo", "TableMeta",
           "TableType"]
