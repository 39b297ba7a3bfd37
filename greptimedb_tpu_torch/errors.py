"""Error taxonomy with status codes.

Reference behavior: src/common/error/src/{ext.rs,status_code.rs} — every
error carries a StatusCode so protocol servers can map it onto MySQL/PG/HTTP
error spaces uniformly.
"""

from __future__ import annotations

import enum


class StatusCode(enum.IntEnum):
    # Success
    SUCCESS = 0
    # Unknown / unexpected
    UNKNOWN = 1000
    UNSUPPORTED = 1001
    UNEXPECTED = 1002
    INTERNAL = 1003
    INVALID_ARGUMENTS = 1004
    # SQL
    INVALID_SYNTAX = 2000
    # Query
    PLAN_QUERY = 3000
    ENGINE_EXECUTE_QUERY = 3001
    # Catalog
    TABLE_ALREADY_EXISTS = 4000
    TABLE_NOT_FOUND = 4001
    TABLE_COLUMN_NOT_FOUND = 4002
    TABLE_COLUMN_EXISTS = 4003
    DATABASE_NOT_FOUND = 4004
    DATABASE_ALREADY_EXISTS = 4005
    # Storage
    STORAGE_UNAVAILABLE = 5000
    REGION_NOT_FOUND = 5001
    REGION_ALREADY_EXISTS = 5002
    # Server
    RUNTIME_RESOURCES_EXHAUSTED = 6000
    RATE_LIMITED = 6001
    # Auth
    USER_NOT_FOUND = 7000
    UNSUPPORTED_PASSWORD_TYPE = 7001
    USER_PASSWORD_MISMATCH = 7002
    AUTH_HEADER_NOT_FOUND = 7003
    INVALID_AUTH_HEADER = 7004
    ACCESS_DENIED = 7005


class GreptimeError(Exception):
    """Base error. Subclasses set `status_code`."""

    status_code: StatusCode = StatusCode.UNKNOWN

    def __init__(self, msg: str = "", *, cause: BaseException | None = None):
        super().__init__(msg)
        self.msg = msg
        if cause is not None:
            self.__cause__ = cause

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.msg or self.__class__.__name__

    def to_http_status(self) -> int:
        c = self.status_code
        if c in (StatusCode.USER_NOT_FOUND, StatusCode.USER_PASSWORD_MISMATCH,
                 StatusCode.AUTH_HEADER_NOT_FOUND, StatusCode.INVALID_AUTH_HEADER,
                 StatusCode.UNSUPPORTED_PASSWORD_TYPE):
            return 401
        if c == StatusCode.ACCESS_DENIED:
            return 403
        if c in (StatusCode.TABLE_NOT_FOUND, StatusCode.DATABASE_NOT_FOUND,
                 StatusCode.REGION_NOT_FOUND, StatusCode.TABLE_COLUMN_NOT_FOUND):
            return 404
        if c in (StatusCode.INVALID_SYNTAX, StatusCode.INVALID_ARGUMENTS,
                 StatusCode.TABLE_ALREADY_EXISTS, StatusCode.DATABASE_ALREADY_EXISTS,
                 StatusCode.TABLE_COLUMN_EXISTS):
            return 400
        if c == StatusCode.RATE_LIMITED:
            return 429
        return 500


class UnsupportedError(GreptimeError):
    status_code = StatusCode.UNSUPPORTED


class InternalError(GreptimeError):
    status_code = StatusCode.INTERNAL


class InvalidArgumentsError(GreptimeError):
    status_code = StatusCode.INVALID_ARGUMENTS


class SyntaxError_(GreptimeError):
    status_code = StatusCode.INVALID_SYNTAX


class PlanError(GreptimeError):
    status_code = StatusCode.PLAN_QUERY


class ExecutionError(GreptimeError):
    status_code = StatusCode.ENGINE_EXECUTE_QUERY


class TableAlreadyExistsError(GreptimeError):
    status_code = StatusCode.TABLE_ALREADY_EXISTS


class TableNotFoundError(GreptimeError):
    status_code = StatusCode.TABLE_NOT_FOUND


class ColumnNotFoundError(GreptimeError):
    status_code = StatusCode.TABLE_COLUMN_NOT_FOUND


class ColumnExistsError(GreptimeError):
    status_code = StatusCode.TABLE_COLUMN_EXISTS


class DatabaseNotFoundError(GreptimeError):
    status_code = StatusCode.DATABASE_NOT_FOUND


class DatabaseAlreadyExistsError(GreptimeError):
    status_code = StatusCode.DATABASE_ALREADY_EXISTS


class StorageError(GreptimeError):
    status_code = StatusCode.STORAGE_UNAVAILABLE


class SchedulerStoppedError(StorageError, RuntimeError):
    """Background scheduler rejected a submit because it is shutting
    down. Inherits RuntimeError so pre-taxonomy `except RuntimeError`
    shutdown paths keep degrading gracefully (skip the job; WAL/retry
    machinery covers the data)."""


class RegionClosedError(StorageError):
    """The region is closed on this node (shutdown, or a crashed node's
    in-process twin). To a distributed frontend this is a stale-route
    signal: the region either moved or is being failed over — refresh
    the route and retry, exactly like a dead peer's connection error
    over the wire."""


class RegionNotFoundError(GreptimeError):
    status_code = StatusCode.REGION_NOT_FOUND


class AuthError(GreptimeError):
    status_code = StatusCode.USER_PASSWORD_MISMATCH


class TransientRpcError(GreptimeError):
    """RPC failure a later identical attempt can plausibly outlive —
    connection refused/reset, deadline exceeded, server restarting.
    storage/retry.is_transient recognizes it, so the distributed
    fan-out's per-RPC retry covers real network hops, not just
    failpoint-injected faults."""

    status_code = StatusCode.STORAGE_UNAVAILABLE


class OverloadedError(GreptimeError):
    """The frontend's admission gate rejected new work: in-flight
    statements or queued ingest bytes are past the configured limits.
    Reject-with-retry-after, never collapse: HTTP maps it to 429 with a
    ``Retry-After`` header (`to_http_status` → RATE_LIMITED → 429),
    MySQL to a clean server-busy error (1040), Postgres to SQLSTATE
    53300. Carries the ``overloaded`` wire marker so Flight's
    string-flattened errors rebuild the type client-side."""

    status_code = StatusCode.RATE_LIMITED
    WIRE_MARKER = "server overloaded"

    def __init__(self, msg: str, *, retry_after_s: int = 1):
        if self.WIRE_MARKER not in msg:
            msg = f"{self.WIRE_MARKER}: {msg}"
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class QueryCancelledError(GreptimeError):
    """The statement was killed (`KILL <id>`): cooperative cancellation
    fired at a batch boundary in the streamed scan / scatter-gather
    loops. NOT transient — a retry would re-run the work the operator
    just killed."""

    status_code = StatusCode.ENGINE_EXECUTE_QUERY


class SketchCodecError(GreptimeError):
    """A sketch partial (HLL / t-digest frame from a datanode) failed to
    decode: corrupt, truncated, or version-skewed. The frontend counts
    ``greptime_sketch_degrade_total`` and retries the statement through
    the raw-row path — a bad partial must never become a wrong answer.
    NOT transient: the same partial would re-corrupt on a plain retry of
    the same RPC."""

    status_code = StatusCode.ENGINE_EXECUTE_QUERY


class StaleRouteError(GreptimeError):
    """The caller's region route is out of date: the region moved
    (migrate), was refined away (split), or is fenced for an in-flight
    handoff. The DistTable catches this, refreshes its route + partition
    rule from meta, and retries — so elastic region movement is
    invisible to SQL clients. Every message carries the ``stale route``
    marker because Flight flattens error types to strings on the wire
    (client/flight.py rebuilds the type from it)."""

    status_code = StatusCode.REGION_NOT_FOUND
    WIRE_MARKER = "stale route"

    def __init__(self, msg: str):
        if self.WIRE_MARKER not in msg:
            msg = f"{self.WIRE_MARKER}: {msg}"
        super().__init__(msg)
