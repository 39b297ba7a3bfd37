"""Catalog: catalogs → schemas → tables (in memory until the storage
slice brings the durable catalog)."""

from .manager import CatalogManager, MemoryCatalogManager  # noqa: F401
