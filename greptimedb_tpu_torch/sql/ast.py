"""SQL AST nodes (statements + expressions).

Statement surface mirrors the reference `Statement` enum
(src/sql/src/statements/statement.rs:34-64): Query, Insert, Delete,
CreateTable, CreateExternalTable, CreateDatabase, DropTable, Alter,
ShowDatabases, ShowTables, ShowCreateTable, DescribeTable, Explain, Use,
Tql, Copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

__all__ = [
    "Expr", "Literal", "Column", "Star", "BinaryOp", "UnaryOp",
    "FunctionCall", "WindowSpec", "Between", "InList", "IsNull", "Cast", "Case",
    "Interval", "Placeholder", "Subquery",
    "Statement", "SelectItem", "TableRef", "Join", "Query", "Insert",
    "Delete", "ColumnDef", "PartitionEntry", "Partitions", "CreateTable",
    "CreateDatabase", "DropTable", "DropDatabase", "AlterTable", "AddColumn",
    "DropColumn", "RenameTable", "ShowDatabases", "ShowTables",
    "ShowCreateTable", "DescribeTable", "ShowVariable", "Use", "Tql", "Copy",
    "Explain", "SetVariable", "TruncateTable", "ObjectName",
    "CreateFlow", "DropFlow", "ShowFlows", "Admin",
]


class Expr:
    pass


@dataclass
class Literal(Expr):
    value: Any                      # python value; None for NULL
    kind: str = "auto"              # number | string | bool | null | auto

    def __str__(self):
        if self.value is None:
            return "NULL"
        if self.kind == "string":
            return "'" + str(self.value).replace("'", "''") + "'"
        if self.kind == "bool":
            return "TRUE" if self.value else "FALSE"
        return str(self.value)


@dataclass
class Column(Expr):
    name: str
    table: Optional[str] = None

    def __str__(self):
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclass
class Star(Expr):
    table: Optional[str] = None

    def __str__(self):
        return f"{self.table}.*" if self.table else "*"


@dataclass
class BinaryOp(Expr):
    op: str                         # lowercase: and/or/=/!=/</<=/>/>=/+/-/*///%/like/regexp/||
    left: Expr
    right: Expr

    def __str__(self):
        return f"({self.left} {self.op.upper()} {self.right})"


@dataclass
class UnaryOp(Expr):
    op: str                         # not | - | +
    operand: Expr

    def __str__(self):
        return f"({self.op.upper()} {self.operand})"


@dataclass
class WindowSpec:
    """OVER (...) clause: partitioning, intra-partition order, row frame.

    frame is None (default frame: RANGE UNBOUNDED PRECEDING..CURRENT ROW
    when order_by is set, the whole partition otherwise) or a ROWS frame
    (lo, hi) with offsets relative to the current row — negative =
    preceding, None = unbounded on that side."""
    partition_by: List["Expr"] = field(default_factory=list)
    order_by: List[Tuple["Expr", bool]] = field(default_factory=list)
    frame: Optional[Tuple[Optional[int], Optional[int]]] = None

    def __str__(self):
        parts = []
        if self.partition_by:
            parts.append("PARTITION BY " +
                         ", ".join(str(e) for e in self.partition_by))
        if self.order_by:
            parts.append("ORDER BY " + ", ".join(
                f"{e}{'' if asc else ' DESC'}" for e, asc in self.order_by))
        if self.frame is not None:
            def bound(v, side):
                if v is None:
                    return f"UNBOUNDED {side}"
                if v == 0:
                    return "CURRENT ROW"
                return f"{-v} PRECEDING" if v < 0 else f"{v} FOLLOWING"
            parts.append(f"ROWS BETWEEN {bound(self.frame[0], 'PRECEDING')} "
                         f"AND {bound(self.frame[1], 'FOLLOWING')}")
        return " ".join(parts)


@dataclass
class FunctionCall(Expr):
    name: str                       # lowercase
    args: List[Expr] = field(default_factory=list)
    distinct: bool = False
    over: Optional[WindowSpec] = None   # set → window function

    def __str__(self):
        inner = ", ".join(str(a) for a in self.args)
        if self.distinct:
            inner = "DISTINCT " + inner
        base = f"{self.name}({inner})"
        if self.over is not None:
            return f"{base} OVER ({self.over})"
        return base


@dataclass
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class InList(Expr):
    expr: Expr
    items: List[Expr] = field(default_factory=list)
    negated: bool = False


@dataclass
class IsNull(Expr):
    expr: Expr
    negated: bool = False


@dataclass
class Cast(Expr):
    expr: Expr
    type_name: str


@dataclass
class Case(Expr):
    operand: Optional[Expr]
    whens: List[Tuple[Expr, Expr]] = field(default_factory=list)
    else_: Optional[Expr] = None


@dataclass
class Interval(Expr):
    text: str                       # e.g. "5 minutes" / "1h"


@dataclass
class Placeholder(Expr):
    index: int


@dataclass
class Subquery(Expr):
    query: "Query"


# --------------------------------------------------------------------------
# Statements
# --------------------------------------------------------------------------

class Statement:
    pass


@dataclass
class ObjectName:
    """Up-to-three-part dotted name: [catalog.][schema.]table."""
    parts: List[str]

    @property
    def table(self) -> str:
        return self.parts[-1]

    @property
    def schema(self) -> Optional[str]:
        return self.parts[-2] if len(self.parts) >= 2 else None

    @property
    def catalog(self) -> Optional[str]:
        return self.parts[-3] if len(self.parts) >= 3 else None

    def __str__(self):
        return ".".join(self.parts)


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class TableRef:
    name: Optional[ObjectName] = None
    alias: Optional[str] = None
    subquery: Optional["Query"] = None


@dataclass
class Join:
    kind: str                       # inner | left | right | cross
    table: TableRef
    on: Optional[Expr] = None


@dataclass
class Query(Statement):
    projections: List[SelectItem]
    from_: Optional[TableRef] = None
    joins: List[Join] = field(default_factory=list)
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: List[Tuple[Expr, bool]] = field(default_factory=list)  # (expr, asc)
    #: per-order-key NULLS FIRST(True)/LAST(False); None = SQL default
    #: (NULLS LAST for ASC, NULLS FIRST for DESC — the Postgres rule)
    order_nulls: List[Optional[bool]] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False


@dataclass
class SetQuery(Statement):
    """UNION [ALL] chain; order/limit/offset apply to the whole set."""
    left: Statement                  # Query | SetQuery
    right: "Query" = None
    all: bool = False
    order_by: List[Tuple[Expr, bool]] = field(default_factory=list)
    order_nulls: List[Optional[bool]] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None


@dataclass
class Insert(Statement):
    table: ObjectName
    columns: List[str] = field(default_factory=list)
    rows: List[List[Expr]] = field(default_factory=list)
    select: Optional[Query] = None


@dataclass
class Delete(Statement):
    table: ObjectName
    where: Optional[Expr] = None


@dataclass
class ColumnDef:
    name: str
    type_name: str
    nullable: bool = True
    default: Optional[Expr] = None
    comment: Optional[str] = None
    is_time_index: bool = False
    is_primary_key: bool = False


@dataclass
class PartitionEntry:
    name: str
    values: List[Any]               # literal bound per partition column; "MAXVALUE" sentinel


@dataclass
class Partitions:
    columns: List[str]
    entries: List[PartitionEntry] = field(default_factory=list)
    kind: str = "range"             # "range" | "hash"
    num_partitions: Optional[int] = None   # hash only: bucket count


@dataclass
class CreateTable(Statement):
    name: ObjectName
    columns: List[ColumnDef] = field(default_factory=list)
    time_index: Optional[str] = None
    primary_keys: List[str] = field(default_factory=list)
    partitions: Optional[Partitions] = None
    engine: str = "mito"
    options: dict = field(default_factory=dict)
    if_not_exists: bool = False
    external: bool = False


@dataclass
class CreateDatabase(Statement):
    name: str
    if_not_exists: bool = False


@dataclass
class DropTable(Statement):
    name: ObjectName
    if_exists: bool = False


@dataclass
class DropDatabase(Statement):
    name: str
    if_exists: bool = False


@dataclass
class AddColumn:
    column: ColumnDef
    location: Optional[str] = None  # FIRST / AFTER <col>


@dataclass
class DropColumn:
    name: str


@dataclass
class RenameTable:
    new_name: str


@dataclass
class AlterTable(Statement):
    table: ObjectName
    operation: Any                  # AddColumn | DropColumn | RenameTable


@dataclass
class CreateFlow(Statement):
    """CREATE FLOW name [SINK TO table] AS SELECT <aggs> FROM src
    GROUP BY date_bin(stride, ts)[, tags...] — a continuous rollup
    (reference: GreptimeDB's flow engine CREATE FLOW statement)."""
    name: str
    query: "Query" = None
    sink: Optional[str] = None      # defaults to the flow name
    if_not_exists: bool = False
    raw_sql: str = ""               # SELECT text for SHOW FLOWS


@dataclass
class DropFlow(Statement):
    name: str = ""
    if_exists: bool = False


@dataclass
class ShowFlows(Statement):
    like: Optional[str] = None


@dataclass
class ShowDatabases(Statement):
    like: Optional[str] = None
    where: Optional[Expr] = None


@dataclass
class ShowTables(Statement):
    database: Optional[str] = None
    like: Optional[str] = None
    where: Optional[Expr] = None
    full: bool = False


@dataclass
class ShowCreateTable(Statement):
    table: ObjectName = None


@dataclass
class ShowVariable(Statement):
    name: str = ""


@dataclass
class ShowProcessList(Statement):
    full: bool = False


@dataclass
class Kill(Statement):
    """KILL [QUERY] <id> — cooperative cancellation of a running
    statement from information_schema.processes / SHOW PROCESSLIST."""
    process_id: int = 0


@dataclass
class Admin(Statement):
    """Elastic region administration (meta balancer surface):

    - ``ADMIN MIGRATE REGION <table> <region> TO <node_id>``
    - ``ADMIN SPLIT REGION <table> <region> [AT <literal>]``
    - ``ADMIN REBALANCE [TABLE <table>]``
    - ``ADMIN ADD REPLICA <table> <region> TO <node_id>``
    - ``ADMIN REMOVE REPLICA <table> <region> FROM <node_id>``

    Table maintenance (storage surface; works standalone too):

    - ``ADMIN FLUSH TABLE <table>``
    - ``ADMIN COMPACT TABLE <table>``

    Observability (works on both deployments):

    - ``ADMIN SHOW TRACE '<trace_id>'`` — the reassembled cross-node
      waterfall from ``greptime_private.trace_spans`` ('last' = the
      most recently retained trace on this frontend)
    - ``ADMIN SHOW PROFILE '<query_id>'|'<trace_id>'|'last'`` — the
      continuous profiler's per-node self/total frame tree from
      ``greptime_private.profile_samples`` (``trace_id`` carries the
      id for both SHOW forms)
    """
    #: migrate_region | split_region | rebalance | flush_table |
    #: compact_table | show_trace | show_profile
    kind: str = ""
    table: Optional[ObjectName] = None
    region: Optional[int] = None
    target_node: Optional[int] = None
    at_value: Any = None
    trace_id: Optional[str] = None


@dataclass
class DescribeTable(Statement):
    table: ObjectName = None


@dataclass
class Use(Statement):
    database: str = ""


@dataclass
class Tql(Statement):
    kind: str                       # eval | explain | analyze
    start: str = "0"
    end: str = "0"
    step: str = "5m"
    lookback: Optional[str] = None
    query: str = ""


@dataclass
class Copy(Statement):
    table: ObjectName
    direction: str                  # to | from
    path: str = ""
    options: dict = field(default_factory=dict)


@dataclass
class Explain(Statement):
    statement: Statement = None
    analyze: bool = False
    verbose: bool = False


@dataclass
class SetVariable(Statement):
    name: str = ""
    value: Any = None


@dataclass
class TruncateTable(Statement):
    name: ObjectName = None
