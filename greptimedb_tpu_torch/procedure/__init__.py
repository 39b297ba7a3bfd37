"""Durable procedure framework.

Reference behavior: src/common/procedure — multi-step operations (DDL)
persist each step so a crash mid-procedure resumes instead of leaving
half-applied state: `Procedure` trait with `execute → Status`
(procedure.rs:84), `LocalManager` + `Runner` with retry/backoff
(local.rs:307, local/runner.rs), `ObjectStateStore` writing step JSON to
the object store (store/state_store.rs), `Watcher` for completion
(watcher.rs), and recovery of in-flight procedures on restart
(local.rs:383-417).
"""

from .framework import (
    Procedure, ProcedureManager, RetryLater, Status, Watcher)

__all__ = ["Procedure", "ProcedureManager", "RetryLater", "Status",
           "Watcher"]
