"""Catalog managers.

`MemoryCatalogManager` holds catalogs → schemas → tables in maps.
`LocalCatalogManager` layers persistence on top: databases and table
registrations are durable (a JSON doc on the object store mirrors the
reference's system catalog table, src/catalog/src/system.rs:50), and
`start()` re-opens every registered table through its engine — the analog
of the reference's catalog-table replay on boot
(src/catalog/src/local/manager.rs:640).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from .. import DEFAULT_CATALOG_NAME, DEFAULT_SCHEMA_NAME
from ..errors import (
    DatabaseAlreadyExistsError,
    DatabaseNotFoundError,
    TableAlreadyExistsError,
    TableNotFoundError,
)
from ..table.table import Table, TableEngine
from ..table.requests import OpenTableRequest

SYSTEM_CATALOG_KEY = "catalog/system.json"


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
        from ..common.locks import TrackedRLock
        from ..common.tracking import tracked_state
        self._lock = TrackedRLock("catalog.manager")
        self._catalogs: Dict[str, Dict[str, Dict[str, Table]]] = \
            tracked_state({
                DEFAULT_CATALOG_NAME: {DEFAULT_SCHEMA_NAME: {}},
            }, "catalog.manager.catalogs")

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


class LocalCatalogManager(MemoryCatalogManager):
    """Durable catalog over an object store + table engines.

    Registrations are written to `catalog/system.json`; `start()` replays
    it, re-opening tables via their engine (engines recover schema/data from
    their own manifests).
    """

    def __init__(self, store, engines: Dict[str, TableEngine]):
        super().__init__()
        self.store = store
        self.engines = engines
        self._doc_key = SYSTEM_CATALOG_KEY
        self._started = False
        # registrations whose engine was unavailable at start(); preserved
        # verbatim in the system doc so a config fix can recover them
        self._orphans: List[dict] = []

    # ---- persistence ----
    def _load_doc(self) -> dict:
        if self.store.exists(self._doc_key):
            return json.loads(self.store.read(self._doc_key))
        return {"schemas": [[DEFAULT_CATALOG_NAME, DEFAULT_SCHEMA_NAME]],
                "tables": []}

    def _save_doc(self) -> None:
        with self._lock:
            schemas = [[c, s] for c in self._catalogs
                       for s in self._catalogs[c]]
            tables = [{"catalog": c, "schema": s, "name": n,
                       "engine": t.info.meta.engine}
                      for c in self._catalogs
                      for s in self._catalogs[c]
                      for n, t in self._catalogs[c][s].items()
                      if t.info.meta.engine in self.engines]
        self.store.write(self._doc_key, json.dumps(
            {"schemas": schemas,
             "tables": tables + list(self._orphans)}).encode())

    def start(self) -> None:
        """Replay the system catalog: register schemas, re-open tables."""
        doc = self._load_doc()
        with self._lock:
            for c, s in doc["schemas"]:
                self._catalogs.setdefault(c, {}).setdefault(s, {})
        import logging
        for ent in doc["tables"]:
            engine = self.engines.get(ent["engine"])
            table = None
            if engine is not None:
                table = engine.open_table(OpenTableRequest(
                    ent["name"], ent["catalog"], ent["schema"]))
            if table is None:
                logging.getLogger(__name__).warning(
                    "catalog: cannot open %s.%s.%s (engine %r); keeping "
                    "its registration", ent["catalog"], ent["schema"],
                    ent["name"], ent["engine"])
                self._orphans.append(ent)
                continue
            with self._lock:
                self._catalogs[ent["catalog"]][ent["schema"]][
                    ent["name"]] = table
        self._started = True

    # ---- durable mutations ----
    def register_schema(self, catalog: str, schema: str) -> None:
        super().register_schema(catalog, schema)
        self._save_doc()

    def deregister_schema(self, catalog: str, schema: str) -> None:
        super().deregister_schema(catalog, schema)
        self._save_doc()

    def register_table(self, catalog: str, schema: str, name: str,
                       table: Table) -> None:
        super().register_table(catalog, schema, name, table)
        self._save_doc()

    def deregister_table(self, catalog: str, schema: str, name: str) -> None:
        super().deregister_table(catalog, schema, name)
        self._save_doc()

    def rename_table(self, catalog: str, schema: str, name: str,
                     new_name: str) -> None:
        super().rename_table(catalog, schema, name, new_name)
        self._save_doc()
