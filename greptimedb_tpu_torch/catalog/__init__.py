"""Catalog: resolve catalog.schema.table → Table.

Reference behavior: src/catalog — `CatalogManager/CatalogProvider/
SchemaProvider` traits (src/catalog/src/lib.rs:45-110),
`MemoryCatalogManager` (src/catalog/src/local/memory.rs) and
`LocalCatalogManager` persisting registrations so restart re-opens tables
(src/catalog/src/local/manager.rs).
"""

from .manager import CatalogManager, MemoryCatalogManager, LocalCatalogManager

__all__ = ["CatalogManager", "MemoryCatalogManager", "LocalCatalogManager"]
