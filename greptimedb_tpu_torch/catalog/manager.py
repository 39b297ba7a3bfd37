"""Catalog managers.

`MemoryCatalogManager` holds catalogs → schemas → tables in maps. The
durable catalog (registrations persisted on an object store and replayed
through the table engines at start) comes with the storage slice.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .. import DEFAULT_CATALOG_NAME, DEFAULT_SCHEMA_NAME
from ..errors import (
    DatabaseAlreadyExistsError,
    DatabaseNotFoundError,
    TableAlreadyExistsError,
    TableNotFoundError,
)
from ..table.table import Table


class CatalogManager:
    def catalog_names(self) -> List[str]:
        raise NotImplementedError

    def schema_names(self, catalog: str) -> List[str]:
        raise NotImplementedError

    def table_names(self, catalog: str, schema: str) -> List[str]:
        raise NotImplementedError

    def table(self, catalog: str, schema: str, name: str) -> Optional[Table]:
        raise NotImplementedError

    def register_table(self, catalog: str, schema: str, name: str,
                       table: Table) -> None:
        raise NotImplementedError

    def deregister_table(self, catalog: str, schema: str, name: str) -> None:
        raise NotImplementedError

    def register_schema(self, catalog: str, schema: str) -> None:
        raise NotImplementedError

    def deregister_schema(self, catalog: str, schema: str) -> None:
        raise NotImplementedError

    def schema_exists(self, catalog: str, schema: str) -> bool:
        return schema in self.schema_names(catalog)

    def table_exists(self, catalog: str, schema: str, name: str) -> bool:
        return self.table(catalog, schema, name) is not None


class MemoryCatalogManager(CatalogManager):
    """In-memory catalogs (reference: src/catalog/src/local/memory.rs:592)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._catalogs: Dict[str, Dict[str, Dict[str, Table]]] = {
            DEFAULT_CATALOG_NAME: {DEFAULT_SCHEMA_NAME: {}},
        }

    def catalog_names(self) -> List[str]:
        with self._lock:
            return sorted(self._catalogs)

    def schema_names(self, catalog: str) -> List[str]:
        with self._lock:
            if catalog not in self._catalogs:
                raise DatabaseNotFoundError(f"catalog {catalog!r} not found")
            return sorted(self._catalogs[catalog])

    def table_names(self, catalog: str, schema: str) -> List[str]:
        with self._lock:
            schemas = self._catalogs.get(catalog)
            if schemas is None or schema not in schemas:
                raise DatabaseNotFoundError(
                    f"schema {catalog}.{schema} not found")
            return sorted(schemas[schema])

    def table(self, catalog: str, schema: str, name: str) -> Optional[Table]:
        with self._lock:
            return self._catalogs.get(catalog, {}).get(schema, {}).get(name)

    def register_catalog(self, catalog: str) -> None:
        with self._lock:
            self._catalogs.setdefault(catalog, {})

    def register_schema(self, catalog: str, schema: str) -> None:
        with self._lock:
            schemas = self._catalogs.setdefault(catalog, {})
            if schema in schemas:
                raise DatabaseAlreadyExistsError(
                    f"schema {catalog}.{schema} already exists")
            schemas[schema] = {}

    def deregister_schema(self, catalog: str, schema: str) -> None:
        with self._lock:
            schemas = self._catalogs.get(catalog)
            if schemas is None or schema not in schemas:
                raise DatabaseNotFoundError(
                    f"schema {catalog}.{schema} not found")
            if schemas[schema]:
                from ..errors import InvalidArgumentsError
                raise InvalidArgumentsError(
                    f"schema {catalog}.{schema} is not empty")
            del schemas[schema]

    def register_table(self, catalog: str, schema: str, name: str,
                       table: Table) -> None:
        with self._lock:
            schemas = self._catalogs.setdefault(catalog, {})
            tables = schemas.setdefault(schema, {})
            if name in tables:
                raise TableAlreadyExistsError(
                    f"table {catalog}.{schema}.{name} already exists")
            tables[name] = table

    def deregister_table(self, catalog: str, schema: str, name: str) -> None:
        with self._lock:
            tables = self._catalogs.get(catalog, {}).get(schema)
            if tables is None or name not in tables:
                raise TableNotFoundError(
                    f"table {catalog}.{schema}.{name} not found")
            del tables[name]

    def rename_table(self, catalog: str, schema: str, name: str,
                     new_name: str) -> None:
        with self._lock:
            tables = self._catalogs.get(catalog, {}).get(schema)
            if tables is None or name not in tables:
                raise TableNotFoundError(
                    f"table {catalog}.{schema}.{name} not found")
            if new_name in tables:
                raise TableAlreadyExistsError(
                    f"table {catalog}.{schema}.{new_name} already exists")
            tables[new_name] = tables.pop(name)
