"""Procedure-backed DDL for the mito engine.

Reference behavior: src/mito/src/engine/procedure/{create,alter,drop}.rs
(+ src/table-procedure gluing catalog and engine): CREATE/ALTER/DROP run
as durable procedures whose steps persist, so a crash between "engine
applied" and "catalog registered" resumes to a consistent end state
instead of leaving a half-created table.

Steps (mirroring CreateMitoTable's state machine, create.rs:60-260):
  create: engine_create → register_catalog → done
  drop:   engine_drop → deregister_catalog → done
  alter:  engine_alter → update_catalog → done
Every step is idempotent: the engine's manifest-first create/open and the
catalog register/deregister calls tolerate replay.
"""

from __future__ import annotations

from typing import Optional

from ..procedure import Procedure, Status
from ..table.requests import (
    AlterKind, AlterTableRequest, CreateTableRequest, DropTableRequest,
    alter_request_from_dict, alter_request_to_dict, create_request_from_dict,
    create_request_to_dict)


class CreateTableProcedure(Procedure):
    type_name = "mito.CreateTable"

    def __init__(self, request: CreateTableRequest, engine, catalog,
                 state: str = "engine_create"):
        self.request = request
        self.engine = engine
        self.catalog = catalog
        self.state = state

    def lock_key(self) -> Optional[str]:
        r = self.request
        return f"{r.catalog_name}.{r.schema_name}.{r.table_name}"

    def execute(self, ctx) -> Status:
        if self.state == "engine_create":
            # resume-safe: an already-created table is re-opened via its
            # manifest rather than failed (engine create is idempotent
            # under create_if_not_exists)
            req = self.request
            if not req.create_if_not_exists:
                import dataclasses
                req = dataclasses.replace(req, create_if_not_exists=True)
            self._table = self.engine.create_table(req)
            self.state = "register_catalog"
            return Status.executing()
        if self.state == "register_catalog":
            r = self.request
            if not hasattr(self, "_table"):
                self._table = self.engine.create_table(
                    _with_if_not_exists(self.request))
            if self.catalog.table(r.catalog_name, r.schema_name,
                                  r.table_name) is None:
                self.catalog.register_table(
                    r.catalog_name, r.schema_name, r.table_name,
                    self._table)
            return Status.done()
        raise ValueError(f"unknown state {self.state!r}")

    def dump(self) -> dict:
        return {"state": self.state,
                "request": create_request_to_dict(self.request)}

    @staticmethod
    def loader(engine, catalog):
        def load(data: dict) -> "CreateTableProcedure":
            return CreateTableProcedure(
                create_request_from_dict(data["request"]), engine, catalog,
                state=data["state"])
        return load


def _with_if_not_exists(req: CreateTableRequest) -> CreateTableRequest:
    import dataclasses
    return req if req.create_if_not_exists else \
        dataclasses.replace(req, create_if_not_exists=True)


class DropTableProcedure(Procedure):
    type_name = "mito.DropTable"

    def __init__(self, request: DropTableRequest, engine, catalog,
                 state: str = "engine_drop"):
        self.request = request
        self.engine = engine
        self.catalog = catalog
        self.state = state

    def lock_key(self) -> Optional[str]:
        r = self.request
        return f"{r.catalog_name}.{r.schema_name}.{r.table_name}"

    def execute(self, ctx) -> Status:
        r = self.request
        if self.state == "engine_drop":
            self.engine.drop_table(r)     # returns False if already gone
            self.state = "deregister_catalog"
            return Status.executing()
        if self.state == "deregister_catalog":
            self.catalog.deregister_table(r.catalog_name, r.schema_name,
                                          r.table_name)
            return Status.done()
        raise ValueError(f"unknown state {self.state!r}")

    def dump(self) -> dict:
        r = self.request
        return {"state": self.state,
                "request": {"table_name": r.table_name,
                            "catalog_name": r.catalog_name,
                            "schema_name": r.schema_name}}

    @staticmethod
    def loader(engine, catalog):
        def load(data: dict) -> "DropTableProcedure":
            d = data["request"]
            return DropTableProcedure(
                DropTableRequest(d["table_name"], d["catalog_name"],
                                 d["schema_name"]),
                engine, catalog, state=data["state"])
        return load


class AlterTableProcedure(Procedure):
    type_name = "mito.AlterTable"

    def __init__(self, request: AlterTableRequest, engine, catalog,
                 state: str = "engine_alter"):
        self.request = request
        self.engine = engine
        self.catalog = catalog
        self.state = state

    def lock_key(self) -> Optional[str]:
        r = self.request
        return f"{r.catalog_name}.{r.schema_name}.{r.table_name}"

    def execute(self, ctx) -> Status:
        r = self.request
        if self.state == "engine_alter":
            from ..errors import ColumnExistsError
            try:
                self.engine.alter_table(r)
            except ColumnExistsError:
                # replayed add-column after a crash between apply+commit
                pass
            self.state = "update_catalog"
            return Status.executing()
        if self.state == "update_catalog":
            if r.kind == AlterKind.RENAME_TABLE and \
                    self.catalog.table(r.catalog_name, r.schema_name,
                                       r.table_name) is not None:
                self.catalog.rename_table(r.catalog_name, r.schema_name,
                                          r.table_name, r.new_table_name)
            return Status.done()
        raise ValueError(f"unknown state {self.state!r}")

    def dump(self) -> dict:
        return {"state": self.state,
                "request": alter_request_to_dict(self.request)}

    @staticmethod
    def loader(engine, catalog):
        def load(data: dict) -> "AlterTableProcedure":
            return AlterTableProcedure(
                alter_request_from_dict(data["request"]), engine, catalog,
                state=data["state"])
        return load


def register_loaders(manager, engine, catalog) -> None:
    """Bind DDL procedure loaders to a datanode's engine+catalog
    (reference: procedure loader registration,
    src/datanode/src/instance.rs:210-236)."""
    manager.register_loader(CreateTableProcedure.type_name,
                            CreateTableProcedure.loader(engine, catalog))
    manager.register_loader(DropTableProcedure.type_name,
                            DropTableProcedure.loader(engine, catalog))
    manager.register_loader(AlterTableProcedure.type_name,
                            AlterTableProcedure.loader(engine, catalog))
