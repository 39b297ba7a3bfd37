"""Recursive-descent SQL parser producing greptimedb_tpu.sql.ast nodes.

Grammar follows the reference's sqlparser-rs dialect plus the GreptimeDB
extensions (src/sql/src/parsers/): TIME INDEX column option and constraint,
PARTITION BY RANGE COLUMNS with MAXVALUE bounds, ENGINE=/WITH() table
options, TQL EVAL/EXPLAIN/ANALYZE, COPY TO/FROM.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from .ast import *  # noqa: F401,F403
from .ast import (
    AddColumn, Admin, AlterTable, Between, BinaryOp, Case, Cast, Column,
    ColumnDef,
    Copy, CreateDatabase, CreateFlow, CreateTable, Delete, DescribeTable,
    DropColumn, DropDatabase, DropFlow, DropTable, Explain, Expr,
    FunctionCall, InList, Insert, Interval, IsNull, Join, Kill, Literal,
    ObjectName, PartitionEntry, Partitions, Placeholder, Query, RenameTable,
    SelectItem, SetQuery, SetVariable, ShowCreateTable, ShowDatabases,
    ShowFlows, ShowProcessList, ShowTables, ShowVariable, Star, Statement,
    Subquery, TableRef, Tql, TruncateTable, UnaryOp, Use,
)
from ..errors import SyntaxError_
from .tokenizer import EOF, IDENT, NUMBER, OP, QIDENT, STRING, Token, tokenize


class ParserError(SyntaxError_, ValueError):
    """SQL parse failure. Joins the errors.* taxonomy (INVALID_SYNTAX)
    so a parse error crossing any protocol boundary carries a real
    status code (HTTP 400, not a generic 500 — the greptlint GL10
    burn-down); still a ValueError for the pre-taxonomy `except
    ValueError` call sites."""


# keywords that terminate a SELECT item list's expression context
_CLAUSE_KEYWORDS = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "UNION",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "ON", "AS", "ASC",
    "DESC", "AND", "OR", "NOT", "THEN", "ELSE", "END", "WHEN",
}

_TYPE_KEYWORDS = {
    "BOOLEAN", "BOOL", "TINYINT", "SMALLINT", "INT", "INTEGER", "BIGINT",
    "FLOAT", "DOUBLE", "REAL", "STRING", "TEXT", "VARCHAR", "CHAR", "BINARY",
    "VARBINARY", "BLOB", "BYTEA", "DATE", "DATETIME", "TIMESTAMP", "INT8",
    "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64",
    "FLOAT32", "FLOAT64", "TIMESTAMP_S", "TIMESTAMP_MS", "TIMESTAMP_US",
    "TIMESTAMP_NS",
}


def parse_sql(sql: str) -> Statement:
    """Parse a single SQL statement."""
    stmts = parse_statements(sql)
    if len(stmts) != 1:
        raise ParserError(f"expected one statement, got {len(stmts)}")
    return stmts[0]


def parse_statements(sql: str) -> List[Statement]:
    stmt = _fast_parse_insert(sql)
    if stmt is not None:
        return [stmt]
    return Parser(sql).parse_statements()


# bulk INSERT ... VALUES hot path: one C-speed regex scan instead of the
# general tokenizer (which builds ~9 Token objects per row — tokenize alone
# cost 31ms per 2000-row statement; this scanner takes ~2ms)
import re as _re2  # noqa: E402

_INS_HEAD = _re2.compile(
    r"""\s*INSERT\s+INTO\s+
        (?P<name>[A-Za-z_$][\w$]*(?:\.[A-Za-z_$][\w$]*){0,2}
         |"[^"]+"|`[^`]+`)\s*
        (?:\(\s*(?P<cols>[^)]*?)\s*\)\s*)?
        VALUES\s*""", _re2.I | _re2.X)
_INS_VALUE = _re2.compile(
    r"""\s*(?:
        (?P<str>'(?:[^'\\]|''|\\.)*')
      | (?P<num>[-+]?(?:0[xX][0-9a-fA-F]+|(?:\d+\.?\d*|\.\d+)
                      (?:[eE][+-]?\d+)?))
      | (?P<kw>[Nn][Uu][Ll][Ll]|[Tt][Rr][Uu][Ee]|[Ff][Aa][Ll][Ss][Ee])
        )\s*(?P<sep>[,)])""", _re2.X)
_INS_ROW_SEP = _re2.compile(r"\s*(?:,\s*\(|\(|;?\s*$)")
_SIMPLE_INS_STR = _re2.compile(r"'[^'\\]*'\Z")


def _fast_parse_insert(sql: str):
    """Parse `INSERT INTO t [(cols)] VALUES (...), ...` without the
    tokenizer. Returns None (fall back to the grammar) on anything
    fancier: expressions, functions, placeholders, INSERT..SELECT."""
    m = _INS_HEAD.match(sql)
    if m is None:
        return None
    name = m.group("name")
    if name[0] in "\"`":
        parts = [name[1:-1]]
    else:
        parts = name.split(".")
    columns: List[str] = []
    if m.group("cols"):
        for c in m.group("cols").split(","):
            c = c.strip()
            if c and c[0] in "\"`":
                c = c[1:-1]
            if not c or not _re2.fullmatch(r"[\w$]+|\S+", c):
                return None
            columns.append(c)
    pos = m.end()
    n = len(sql)
    rows: List[List[Expr]] = []
    match_row = _INS_ROW_SEP.match
    match_val = _INS_VALUE.match
    lit = Literal
    while True:
        rs = match_row(sql, pos)
        if rs is None:
            return None
        tok = rs.group().strip()
        if tok in ("", ";"):
            if rs.end() < n or not rows:
                return None
            return Insert(ObjectName(parts), columns, rows)
        pos = rs.end()
        row: List[Expr] = []
        append = row.append
        while True:
            vm = match_val(sql, pos)
            if vm is None:
                return None          # expression / DEFAULT / empty tuple
            pos = vm.end()
            s, num, kw, sep = vm.group("str", "num", "kw", "sep")
            if num is not None:
                low = num.lower()
                if "." in num or "e" in low:
                    v = float(num)
                elif "x" in low:
                    v = int(num, 16)
                else:
                    v = int(num)
                append(lit(v, "number"))
            elif s is not None:
                if _SIMPLE_INS_STR.match(s):
                    append(lit(s[1:-1], "string"))
                else:
                    from .tokenizer import _read_quoted
                    val, _ = _read_quoted(s, 0, "'")
                    append(lit(val, "string"))
            else:
                kw = kw.upper()
                append(lit(None, "null") if kw == "NULL"
                       else lit(kw == "TRUE", "bool"))
            if sep == ")":
                break
        rows.append(row)


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0
        self._placeholders = 0

    # ---- token helpers ----
    def peek(self, ahead: int = 0) -> Token:
        j = min(self.i + ahead, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != EOF:
            self.i += 1
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == IDENT and t.upper() in words

    def match_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.match_kw(word):
            t = self.peek()
            raise ParserError(
                f"expected {word}, found {t.value!r} at offset {t.pos}")

    def match_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == OP and t.value == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.match_op(op):
            t = self.peek()
            raise ParserError(
                f"expected {op!r}, found {t.value!r} at offset {t.pos}")

    def parse_identifier(self) -> str:
        t = self.peek()
        if t.kind in (IDENT, QIDENT):
            self.next()
            return t.value
        raise ParserError(f"expected identifier, found {t.value!r} at {t.pos}")

    def parse_object_name(self) -> ObjectName:
        parts = [self.parse_identifier()]
        while self.match_op("."):
            parts.append(self.parse_identifier())
        if len(parts) > 3:
            raise ParserError(f"too many name parts: {'.'.join(parts)}")
        return ObjectName(parts)

    # ---- statements ----
    def parse_statements(self) -> List[Statement]:
        stmts: List[Statement] = []
        while True:
            while self.match_op(";"):
                pass
            if self.peek().kind == EOF:
                return stmts
            stmts.append(self.parse_statement())
            if not (self.match_op(";") or self.peek().kind == EOF):
                t = self.peek()
                raise ParserError(
                    f"unexpected {t.value!r} at offset {t.pos}")

    def parse_statement(self) -> Statement:
        t = self.peek()
        kw = t.upper() if t.kind == IDENT else ""
        if kw == "SELECT" or (t.kind == OP and t.value == "("):
            return self.parse_query()
        if kw == "WITH":
            return self.parse_with()
        if kw == "CREATE":
            return self.parse_create()
        if kw == "DROP":
            return self.parse_drop()
        if kw == "INSERT":
            return self.parse_insert()
        if kw == "DELETE":
            return self.parse_delete()
        if kw == "ALTER":
            return self.parse_alter()
        if kw == "SHOW":
            return self.parse_show()
        if kw in ("DESCRIBE", "DESC"):
            self.next()
            self.match_kw("TABLE")
            return DescribeTable(table=self.parse_object_name())
        if kw == "USE":
            self.next()
            return Use(database=self.parse_identifier())
        if kw == "TQL":
            return self.parse_tql()
        if kw == "COPY":
            return self.parse_copy()
        if kw == "EXPLAIN":
            return self.parse_explain()
        if kw == "SET":
            return self.parse_set()
        if kw == "TRUNCATE":
            self.next()
            self.match_kw("TABLE")
            return TruncateTable(name=self.parse_object_name())
        if kw == "KILL":
            return self.parse_kill()
        if kw == "ADMIN":
            return self.parse_admin()
        raise ParserError(f"unsupported statement start: {t.value!r} at {t.pos}")

    def parse_admin(self) -> Admin:
        """Elastic region administration:

        - ADMIN MIGRATE REGION <table> <region> TO <node_id>
        - ADMIN SPLIT REGION <table> <region> [AT <literal>]
        - ADMIN REBALANCE [TABLE <table>]
        - ADMIN ADD REPLICA <table> <region> TO <node_id>
        - ADMIN REMOVE REPLICA <table> <region> FROM <node_id>

        Plus table maintenance (storage surface, both deployments):

        - ADMIN FLUSH TABLE <table>
        - ADMIN COMPACT TABLE <table>

        And the observability surfaces:

        - ADMIN SHOW TRACE '<trace_id>'  ('last' = most recently
          retained trace on this frontend)
        - ADMIN SHOW PROFILE '<query_id>'|'<trace_id>'|'last' — the
          continuous profiler's per-node self/total frame tree
        """
        self.expect_kw("ADMIN")
        if self.match_kw("SHOW"):
            what = "TRACE" if self.match_kw("TRACE") else \
                ("PROFILE" if self.match_kw("PROFILE") else None)
            if what is None:
                t = self.peek()
                raise ParserError(
                    f"expected TRACE or PROFILE after ADMIN SHOW, "
                    f"found {t.value!r} at {t.pos}")
            t = self.next()
            if t.kind != STRING:
                raise ParserError(
                    f"ADMIN SHOW {what} needs a quoted id (or 'last'), "
                    f"found {t.value!r} at {t.pos}")
            kind = "show_trace" if what == "TRACE" else "show_profile"
            return Admin(kind=kind, trace_id=str(t.value))
        if self.match_kw("FLUSH"):
            self.expect_kw("TABLE")
            return Admin(kind="flush_table",
                         table=self.parse_object_name())
        if self.match_kw("COMPACT"):
            self.expect_kw("TABLE")
            return Admin(kind="compact_table",
                         table=self.parse_object_name())
        if self.match_kw("REBALANCE"):
            table = None
            if self.match_kw("TABLE"):
                table = self.parse_object_name()
            return Admin(kind="rebalance", table=table)
        if self.match_kw("MIGRATE"):
            self.expect_kw("REGION")
            table = self.parse_object_name()
            region = self._parse_int("region number")
            self.expect_kw("TO")
            target = self._parse_int("target datanode id")
            return Admin(kind="migrate_region", table=table,
                         region=region, target_node=target)
        if self.match_kw("SPLIT"):
            self.expect_kw("REGION")
            table = self.parse_object_name()
            region = self._parse_int("region number")
            at_value = None
            if self.match_kw("AT"):
                at_value = self._parse_literal_value()
                if at_value is None:
                    raise ParserError("ADMIN SPLIT ... AT needs a "
                                      "concrete literal, not NULL")
            return Admin(kind="split_region", table=table, region=region,
                         at_value=at_value)
        if self.match_kw("ADD"):
            self.expect_kw("REPLICA")
            table = self.parse_object_name()
            region = self._parse_int("region number")
            self.expect_kw("TO")
            target = self._parse_int("target datanode id")
            return Admin(kind="add_replica", table=table,
                         region=region, target_node=target)
        if self.match_kw("REMOVE"):
            self.expect_kw("REPLICA")
            table = self.parse_object_name()
            region = self._parse_int("region number")
            self.expect_kw("FROM")
            target = self._parse_int("replica datanode id")
            return Admin(kind="remove_replica", table=table,
                         region=region, target_node=target)
        t = self.peek()
        raise ParserError(
            f"expected MIGRATE REGION / SPLIT REGION / REBALANCE / "
            f"ADD REPLICA / REMOVE REPLICA / FLUSH TABLE / "
            f"COMPACT TABLE / SHOW TRACE / SHOW PROFILE "
            f"after ADMIN, found {t.value!r} at {t.pos}")

    def parse_kill(self) -> Kill:
        """KILL [QUERY] <id> — the id is the `id` column of
        information_schema.processes / SHOW PROCESSLIST."""
        self.expect_kw("KILL")
        self.match_kw("QUERY")
        t = self.next()
        if t.kind != NUMBER:
            raise ParserError(
                f"KILL expects a numeric query id, got {t.value!r} at "
                f"{t.pos}")
        return Kill(process_id=self._to_int(t))

    # ---- WITH (CTE) ----
    def parse_with(self) -> Statement:
        """WITH name [(cols)] AS (query) [, ...] SELECT ...

        CTEs are inlined as derived tables (the FROM-subquery form the
        planner already executes); each reference gets its own deep copy,
        so a CTE used twice behaves like two subqueries — the reference
        gets the same semantics from sqlparser-rs + DataFusion
        (src/sql/src/parsers/query_parser.rs via sqlparser::parse_query).
        """
        self.expect_kw("WITH")
        if self.match_kw("RECURSIVE"):
            raise ParserError("recursive CTEs are not supported")
        ctes: dict = {}
        while True:
            name = self.parse_identifier()
            cols: List[str] = []
            if self.match_op("("):
                cols.append(self.parse_identifier())
                while self.match_op(","):
                    cols.append(self.parse_identifier())
                self.expect_op(")")
            self.expect_kw("AS")
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            _inline_ctes(q, ctes)       # earlier CTEs visible to later ones
            if cols:
                _apply_cte_column_aliases(q, cols, name)
            if name.lower() in ctes:
                raise ParserError(f"duplicate CTE name {name!r}")
            ctes[name.lower()] = q
            if not self.match_op(","):
                break
        t = self.peek()
        if not (self.at_kw("SELECT") or (t.kind == OP and t.value == "(")):
            raise ParserError(
                f"expected SELECT after WITH clause, found {t.value!r}")
        body = self.parse_query()
        _inline_ctes(body, ctes)
        return body

    # ---- SELECT ----
    def parse_query(self) -> Query:
        q = self.parse_query_body()
        while self.match_kw("UNION"):
            all_ = bool(self.match_kw("ALL"))
            self.match_kw("DISTINCT")
            right = self.parse_query_body()
            q = SetQuery(left=q, right=right, all=all_)
        return self._query_tail(q)

    def parse_query_body(self) -> Query:
        """One SELECT core (or parenthesized query) without the
        ORDER/LIMIT tail — the tail binds to the outermost set op."""
        if self.match_op("("):
            q = self.parse_query()
            self.expect_op(")")
            return q
        self.expect_kw("SELECT")
        distinct = self.match_kw("DISTINCT")
        self.match_kw("ALL")
        projections = [self.parse_select_item()]
        while self.match_op(","):
            projections.append(self.parse_select_item())
        q = Query(projections=projections, distinct=distinct)
        if self.match_kw("FROM"):
            q.from_ = self.parse_table_ref()
            while True:
                join = self.parse_join_opt()
                if join is None:
                    break
                q.joins.append(join)
        if self.match_kw("WHERE"):
            q.where = self.parse_expr()
        if self.match_kw("GROUP"):
            self.expect_kw("BY")
            q.group_by.append(self.parse_expr())
            while self.match_op(","):
                q.group_by.append(self.parse_expr())
        if self.match_kw("HAVING"):
            q.having = self.parse_expr()
        return q

    def _query_tail(self, q: Query) -> Query:
        if self.match_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                e = self.parse_expr()
                asc = True
                if self.match_kw("DESC"):
                    asc = False
                else:
                    self.match_kw("ASC")
                nulls_first: Optional[bool] = None
                if self.match_kw("NULLS"):
                    if self.match_kw("FIRST"):
                        nulls_first = True
                    elif self.match_kw("LAST"):
                        nulls_first = False
                    else:
                        raise ParserError(
                            "expected FIRST or LAST after NULLS")
                q.order_by.append((e, asc))
                q.order_nulls.append(nulls_first)
                if not self.match_op(","):
                    break
        if self.match_kw("LIMIT"):
            q.limit = self._parse_int("LIMIT")
        if self.match_kw("OFFSET"):
            q.offset = self._parse_int("OFFSET")
        return q

    def _parse_int(self, what: str) -> int:
        t = self.next()
        if t.kind != NUMBER:
            raise ParserError(f"expected integer after {what}, got {t.value!r}")
        return self._to_int(t)

    @staticmethod
    def _to_int(t: Token) -> int:
        try:
            if t.value.lower().startswith("0x"):
                return int(t.value, 16)
            return int(t.value, 10)
        except ValueError as e:
            raise ParserError(f"invalid integer {t.value!r} at {t.pos}") from e

    def parse_select_item(self) -> SelectItem:
        t = self.peek()
        if t.kind == OP and t.value == "*":
            self.next()
            return SelectItem(Star())
        expr = self.parse_expr()
        alias = None
        if self.match_kw("AS"):
            alias = self.parse_identifier()
        else:
            nt = self.peek()
            if nt.kind == QIDENT or (nt.kind == IDENT and
                                     nt.upper() not in _CLAUSE_KEYWORDS):
                alias = self.parse_identifier()
        return SelectItem(expr, alias)

    def parse_table_ref(self) -> TableRef:
        if self.match_op("("):
            sub = self.parse_query()
            self.expect_op(")")
            alias = None
            self.match_kw("AS")
            nt = self.peek()
            if nt.kind in (IDENT, QIDENT) and nt.upper() not in _CLAUSE_KEYWORDS:
                alias = self.parse_identifier()
            return TableRef(subquery=sub, alias=alias)
        name = self.parse_object_name()
        alias = None
        if self.match_kw("AS"):
            alias = self.parse_identifier()
        else:
            nt = self.peek()
            if nt.kind == QIDENT or (nt.kind == IDENT and
                                     nt.upper() not in _CLAUSE_KEYWORDS and
                                     nt.upper() not in ("SET",)):
                alias = self.parse_identifier()
        return TableRef(name=name, alias=alias)

    def parse_join_opt(self) -> Optional[Join]:
        kind = None
        if self.match_kw("CROSS"):
            kind = "cross"
        elif self.match_kw("INNER"):
            kind = "inner"
        elif self.match_kw("LEFT"):
            self.match_kw("OUTER")
            kind = "left"
        elif self.match_kw("RIGHT"):
            self.match_kw("OUTER")
            kind = "right"
        elif self.match_kw("FULL"):
            self.match_kw("OUTER")
            kind = "full"
        elif self.at_kw("JOIN"):
            kind = "inner"
        elif self.match_op(","):
            kind = "cross"
            return Join(kind, self.parse_table_ref())
        if kind is None:
            return None
        self.expect_kw("JOIN")
        table = self.parse_table_ref()
        on = None
        if self.match_kw("ON"):
            on = self.parse_expr()
        return Join(kind, table, on)

    # ---- expressions (precedence climbing) ----
    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        left = self.parse_and()
        while self.match_kw("OR"):
            left = BinaryOp("or", left, self.parse_and())
        return left

    def parse_and(self) -> Expr:
        left = self.parse_not()
        while self.match_kw("AND"):
            left = BinaryOp("and", left, self.parse_not())
        return left

    def parse_not(self) -> Expr:
        if self.match_kw("NOT"):
            return UnaryOp("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> Expr:
        left = self.parse_additive()
        while True:
            t = self.peek()
            if t.kind == OP and t.value in ("=", "!=", "<>", "<", "<=", ">",
                                            ">=", "<=>"):
                self.next()
                op = {"<>": "!=", "<=>": "="}.get(t.value, t.value)
                left = BinaryOp(op, left, self.parse_additive())
                continue
            if t.kind == IDENT:
                kw = t.upper()
                negated = False
                save = self.i
                if kw == "NOT":
                    self.next()
                    nxt = self.peek()
                    if nxt.kind == IDENT and nxt.upper() in (
                            "LIKE", "ILIKE", "IN", "BETWEEN", "REGEXP"):
                        negated = True
                        kw = nxt.upper()
                        t = nxt
                    else:
                        self.i = save
                        break
                if kw in ("LIKE", "ILIKE"):
                    self.next()
                    node = BinaryOp(kw.lower(), left, self.parse_additive())
                    left = UnaryOp("not", node) if negated else node
                    continue
                if kw == "REGEXP":
                    self.next()
                    node = BinaryOp("regexp", left, self.parse_additive())
                    left = UnaryOp("not", node) if negated else node
                    continue
                if kw == "IN":
                    self.next()
                    self.expect_op("(")
                    if self.at_kw("SELECT"):
                        sub = self.parse_query()
                        self.expect_op(")")
                        left = InList(left, [Subquery(sub)], negated)
                        continue
                    items = [self.parse_expr()]
                    while self.match_op(","):
                        items.append(self.parse_expr())
                    self.expect_op(")")
                    left = InList(left, items, negated)
                    continue
                if kw == "BETWEEN":
                    self.next()
                    low = self.parse_additive()
                    self.expect_kw("AND")
                    high = self.parse_additive()
                    left = Between(left, low, high, negated)
                    continue
                if kw == "IS":
                    self.next()
                    neg = self.match_kw("NOT")
                    self.expect_kw("NULL")
                    left = IsNull(left, neg)
                    continue
            break
        return left

    def parse_additive(self) -> Expr:
        left = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == OP and t.value in ("+", "-", "||"):
                self.next()
                left = BinaryOp(t.value, left, self.parse_multiplicative())
            else:
                return left

    def parse_multiplicative(self) -> Expr:
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == OP and t.value in ("*", "/", "%"):
                self.next()
                left = BinaryOp(t.value, left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> Expr:
        if self.match_op("-"):
            return UnaryOp("-", self.parse_unary())
        if self.match_op("+"):
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self) -> Expr:
        e = self.parse_primary()
        while self.match_op("::"):
            type_name = self._parse_type_name()
            e = Cast(e, type_name)
        return e

    def parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == NUMBER:
            self.next()
            txt = t.value
            if txt.lower().startswith("0x"):
                return Literal(int(txt, 16), "number")
            val = float(txt) if ("." in txt or "e" in txt.lower()) else int(txt)
            return Literal(val, "number")
        if t.kind == STRING:
            self.next()
            return Literal(t.value, "string")
        if t.kind == OP and t.value == "(":
            self.next()
            if self.at_kw("SELECT"):
                sub = self.parse_query()
                self.expect_op(")")
                return Subquery(sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == OP and t.value == "*":
            self.next()
            return Star()
        if t.kind == OP and t.value == "?":
            self.next()
            self._placeholders += 1
            return Placeholder(self._placeholders)
        if t.kind == QIDENT:
            return self._parse_compound_identifier()
        if t.kind == IDENT:
            kw = t.upper()
            if kw in ("TRUE", "FALSE"):
                self.next()
                return Literal(kw == "TRUE", "bool")
            if kw == "NULL":
                self.next()
                return Literal(None, "null")
            if kw == "INTERVAL":
                self.next()
                lit = self.next()
                if lit.kind != STRING:
                    raise ParserError("expected string after INTERVAL")
                unit_tok = self.peek()
                text = lit.value
                if unit_tok.kind == IDENT and unit_tok.upper() in (
                        "SECOND", "SECONDS", "MINUTE", "MINUTES", "HOUR",
                        "HOURS", "DAY", "DAYS", "MILLISECOND", "MILLISECONDS"):
                    self.next()
                    text = f"{text} {unit_tok.value}"
                return Interval(text)
            if kw == "CASE":
                return self._parse_case()
            if kw == "CAST":
                self.next()
                self.expect_op("(")
                e = self.parse_expr()
                self.expect_kw("AS")
                tn = self._parse_type_name()
                self.expect_op(")")
                return Cast(e, tn)
            if kw in ("DATE", "TIMESTAMP") and self.peek(1).kind == STRING:
                self.next()
                lit = self.next()
                return Cast(Literal(lit.value, "string"), kw.lower())
            if kw == "EXISTS" and self.peek(1).kind == OP and \
                    self.peek(1).value == "(":
                self.next()
                self.expect_op("(")
                sub = self.parse_query()
                self.expect_op(")")
                return FunctionCall("exists", [Subquery(sub)])
            if kw in _CLAUSE_KEYWORDS:
                raise ParserError(
                    f"unexpected keyword {t.value!r} at offset {t.pos} "
                    f"(quote it to use as an identifier)")
            return self._parse_compound_identifier()
        raise ParserError(f"unexpected token {t.value!r} at offset {t.pos}")

    def _parse_window_spec(self) -> WindowSpec:
        """OVER ( [PARTITION BY e,...] [ORDER BY e [ASC|DESC],...]
        [ROWS frame] ) — reference: DataFusion's window planning
        (src/query/src/datafusion.rs:61-232 delegates to it)."""
        self.expect_op("(")
        spec = WindowSpec()
        if self.match_kw("PARTITION"):
            self.expect_kw("BY")
            spec.partition_by.append(self.parse_expr())
            while self.match_op(","):
                spec.partition_by.append(self.parse_expr())
        if self.match_kw("ORDER"):
            self.expect_kw("BY")

            def one():
                e = self.parse_expr()
                asc = True
                if self.match_kw("DESC"):
                    asc = False
                elif self.match_kw("ASC"):
                    pass
                return (e, asc)
            spec.order_by.append(one())
            while self.match_op(","):
                spec.order_by.append(one())
        if self.at_kw("ROWS") or self.at_kw("RANGE"):
            kind = self.next().upper()
            if kind == "RANGE":
                raise ParserError("RANGE frames are not supported; "
                                  "use ROWS")

            def bound(default_side: int) -> Optional[int]:
                if self.match_kw("UNBOUNDED"):
                    if not (self.match_kw("PRECEDING") or
                            self.match_kw("FOLLOWING")):
                        raise ParserError("expected PRECEDING/FOLLOWING "
                                          "after UNBOUNDED")
                    return None
                if self.match_kw("CURRENT"):
                    self.expect_kw("ROW")
                    return 0
                n = self._parse_int("frame bound")
                if self.match_kw("PRECEDING"):
                    return -n
                if self.match_kw("FOLLOWING"):
                    return n
                raise ParserError("expected PRECEDING or FOLLOWING")
            if self.match_kw("BETWEEN"):
                lo = bound(-1)
                self.expect_kw("AND")
                hi = bound(1)
            else:
                lo = bound(-1)
                hi = 0
            spec.frame = (lo, hi)
        self.expect_op(")")
        return spec

    def _parse_case(self) -> Expr:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        whens: List[Tuple[Expr, Expr]] = []
        while self.match_kw("WHEN"):
            cond = self.parse_expr()
            self.expect_kw("THEN")
            whens.append((cond, self.parse_expr()))
        else_ = None
        if self.match_kw("ELSE"):
            else_ = self.parse_expr()
        self.expect_kw("END")
        return Case(operand, whens, else_)

    def _parse_compound_identifier(self) -> Expr:
        name = self.parse_identifier()
        # function call?
        if self.peek().kind == OP and self.peek().value == "(":
            self.next()
            distinct = self.match_kw("DISTINCT")
            args: List[Expr] = []
            if not (self.peek().kind == OP and self.peek().value == ")"):
                args.append(self.parse_expr())
                while self.match_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
            fc = FunctionCall(name.lower(), args, distinct)
            if self.at_kw("OVER"):
                self.next()
                fc.over = self._parse_window_spec()
            return fc
        parts = [name]
        while self.peek().kind == OP and self.peek().value == ".":
            # a.b or a.*
            if self.peek(1).kind in (IDENT, QIDENT):
                self.next()
                parts.append(self.parse_identifier())
            elif self.peek(1).kind == OP and self.peek(1).value == "*":
                self.next()
                self.next()
                return Star(table=".".join(parts))
            else:
                break
        if len(parts) == 1:
            return Column(parts[0])
        return Column(parts[-1], table=".".join(parts[:-1]))

    def _parse_type_name(self) -> str:
        base = self.parse_identifier()
        out = base
        # TIMESTAMP(3), VARCHAR(255)
        if self.peek().kind == OP and self.peek().value == "(":
            self.next()
            inner = []
            while not (self.peek().kind == OP and self.peek().value == ")"):
                t = self.next()
                if t.kind == EOF:
                    raise ParserError(
                        f"unterminated type parameter list for {base!r}")
                inner.append(t.value)
            self.expect_op(")")
            if base.upper() == "TIMESTAMP":
                out = f"{base}({','.join(inner)})"
            # length params on varchar/char are ignored
        if self.at_kw("UNSIGNED"):
            self.next()
            out = f"{out} unsigned"
        return out

    # ---- CREATE ----
    def parse_create(self) -> Statement:
        self.expect_kw("CREATE")
        external = self.match_kw("EXTERNAL")
        if self.match_kw("DATABASE") or self.match_kw("SCHEMA"):
            ine = self._parse_if_not_exists()
            return CreateDatabase(self.parse_identifier(), ine)
        if self.at_kw("FLOW"):
            return self.parse_create_flow()
        self.expect_kw("TABLE")
        ine = self._parse_if_not_exists()
        name = self.parse_object_name()
        stmt = CreateTable(name=name, if_not_exists=ine, external=external)
        if self.match_op("("):
            self._parse_create_body(stmt)
        while True:
            if self.match_kw("ENGINE"):
                self.expect_op("=")
                stmt.engine = self.parse_identifier()
            elif self.match_kw("PARTITION"):
                self._parse_partitions(stmt)
            elif self.match_kw("WITH"):
                self.expect_op("(")
                stmt.options.update(self._parse_kv_list())
                self.expect_op(")")
            else:
                break
        # enforce TIME INDEX presence like the reference does for non-external
        if not stmt.external and stmt.columns and stmt.time_index is None:
            raise ParserError("missing TIME INDEX constraint in CREATE TABLE")
        return stmt

    def parse_create_flow(self) -> CreateFlow:
        """CREATE FLOW [IF NOT EXISTS] name [SINK TO table] AS SELECT ...
        (reference: GreptimeDB flow DDL, simplified — the SELECT must be
        a single-table aggregate over date_bin/date_trunc)."""
        self.expect_kw("FLOW")
        ine = self._parse_if_not_exists()
        name = self.parse_identifier()
        sink = None
        if self.match_kw("SINK"):
            self.expect_kw("TO")
            sink = self.parse_identifier()
        self.expect_kw("AS")
        start_pos = self.peek().pos
        if not self.at_kw("SELECT"):
            raise ParserError("expected SELECT after CREATE FLOW ... AS")
        query = self.parse_query()
        end_pos = self.peek().pos if self.peek().kind != EOF \
            else len(self.sql)
        raw = self.sql[start_pos:end_pos].strip().rstrip(";").strip()
        return CreateFlow(name=name, query=query, sink=sink,
                          if_not_exists=ine, raw_sql=raw)

    def _parse_if_not_exists(self) -> bool:
        if self.match_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def _parse_create_body(self, stmt: CreateTable) -> None:
        while True:
            if self.match_kw("PRIMARY"):
                self.expect_kw("KEY")
                self.expect_op("(")
                while True:
                    stmt.primary_keys.append(self.parse_identifier())
                    if not self.match_op(","):
                        break
                self.expect_op(")")
            elif self.at_kw("TIME") and self.peek(1).kind == IDENT and \
                    self.peek(1).upper() == "INDEX":
                # TIME INDEX(col) — lookahead so a column named `time` works
                self.next()
                self.next()
                self.expect_op("(")
                stmt.time_index = self.parse_identifier()
                self.expect_op(")")
            elif self.at_kw("TIMESTAMP_INDEX") and self.peek(1).kind == OP \
                    and self.peek(1).value == "(":
                self.next()
                self.expect_op("(")
                stmt.time_index = self.parse_identifier()
                self.expect_op(")")
            else:
                col = self._parse_column_def()
                stmt.columns.append(col)
                if col.is_time_index:
                    if stmt.time_index is not None and stmt.time_index != col.name:
                        raise ParserError("multiple TIME INDEX columns")
                    stmt.time_index = col.name
                if col.is_primary_key and col.name not in stmt.primary_keys:
                    stmt.primary_keys.append(col.name)
            if self.match_op(","):
                continue
            self.expect_op(")")
            break
        if stmt.time_index and stmt.time_index not in [c.name for c in stmt.columns]:
            raise ParserError(f"TIME INDEX column {stmt.time_index!r} not defined")
        for pk in stmt.primary_keys:
            if pk not in [c.name for c in stmt.columns]:
                raise ParserError(f"PRIMARY KEY column {pk!r} not defined")

    def _parse_column_def(self) -> ColumnDef:
        name = self.parse_identifier()
        type_name = self._parse_type_name()
        col = ColumnDef(name=name, type_name=type_name)
        while True:
            if self.match_kw("NOT"):
                self.expect_kw("NULL")
                col.nullable = False
            elif self.match_kw("NULL"):
                col.nullable = True
            elif self.match_kw("DEFAULT"):
                col.default = self.parse_expr()
            elif self.match_kw("TIME"):
                self.expect_kw("INDEX")
                col.is_time_index = True
                col.nullable = False
            elif self.match_kw("PRIMARY"):
                self.expect_kw("KEY")
                col.is_primary_key = True
            elif self.match_kw("COMMENT"):
                t = self.next()
                col.comment = t.value
            else:
                return col

    def _parse_partitions(self, stmt: CreateTable) -> None:
        # PARTITION BY RANGE COLUMNS (a, b) (PARTITION p0 VALUES LESS THAN (...), ...)
        # PARTITION BY HASH (a, b) PARTITIONS n
        self.expect_kw("BY")
        if self.match_kw("HASH"):
            self.expect_op("(")
            cols = [self.parse_identifier()]
            while self.match_op(","):
                cols.append(self.parse_identifier())
            self.expect_op(")")
            self.expect_kw("PARTITIONS")
            t = self.next()
            try:
                n = int(t.value)
            except (TypeError, ValueError):
                raise ParserError(
                    f"PARTITIONS expects an integer, got {t.value!r} "
                    f"at {t.pos}")
            if n < 1:
                raise ParserError(f"PARTITIONS must be >= 1, got {n}")
            stmt.partitions = Partitions(cols, [], kind="hash",
                                         num_partitions=n)
            return
        self.expect_kw("RANGE")
        self.expect_kw("COLUMNS")
        self.expect_op("(")
        cols = [self.parse_identifier()]
        while self.match_op(","):
            cols.append(self.parse_identifier())
        self.expect_op(")")
        self.expect_op("(")
        entries: List[PartitionEntry] = []
        while True:
            self.expect_kw("PARTITION")
            pname = self.parse_identifier()
            self.expect_kw("VALUES")
            self.expect_kw("LESS")
            self.expect_kw("THAN")
            self.expect_op("(")
            values: List[Any] = []
            while True:
                if self.match_kw("MAXVALUE"):
                    values.append("MAXVALUE")
                else:
                    values.append(self._parse_literal_value())
                if not self.match_op(","):
                    break
            self.expect_op(")")
            entries.append(PartitionEntry(pname, values))
            if not self.match_op(","):
                break
        self.expect_op(")")
        stmt.partitions = Partitions(cols, entries)

    def _parse_literal_value(self) -> Any:
        neg = self.match_op("-")
        t = self.next()
        if t.kind == NUMBER:
            if "." in t.value or "e" in t.value.lower():
                try:
                    v = float(t.value)
                except ValueError as e:
                    raise ParserError(
                        f"invalid number {t.value!r} at {t.pos}") from e
            else:
                v = self._to_int(t)
            return -v if neg else v
        if t.kind == STRING:
            return t.value
        if t.kind == IDENT and t.upper() in ("TRUE", "FALSE"):
            return t.upper() == "TRUE"
        if t.kind == IDENT and t.upper() == "NULL":
            return None
        raise ParserError(f"expected literal, found {t.value!r} at {t.pos}")

    def _parse_kv_list(self) -> dict:
        opts = {}
        if self.peek().kind == OP and self.peek().value == ")":
            return opts
        while True:
            key_parts = [self.parse_identifier()]
            while self.match_op("."):
                key_parts.append(self.parse_identifier())
            self.expect_op("=")
            opts[".".join(key_parts).lower()] = self._parse_literal_value()
            if not self.match_op(","):
                return opts

    # ---- DROP / ALTER ----
    def parse_drop(self) -> Statement:
        self.expect_kw("DROP")
        if self.match_kw("DATABASE") or self.match_kw("SCHEMA"):
            ie = self._parse_if_exists()
            return DropDatabase(self.parse_identifier(), ie)
        if self.match_kw("FLOW"):
            ie = self._parse_if_exists()
            return DropFlow(self.parse_identifier(), ie)
        self.expect_kw("TABLE")
        ie = self._parse_if_exists()
        return DropTable(self.parse_object_name(), ie)

    def _parse_if_exists(self) -> bool:
        if self.match_kw("IF"):
            self.expect_kw("EXISTS")
            return True
        return False

    def parse_alter(self) -> Statement:
        self.expect_kw("ALTER")
        self.expect_kw("TABLE")
        table = self.parse_object_name()
        if self.match_kw("ADD"):
            self.match_kw("COLUMN")
            col = self._parse_column_def()
            location = None
            if self.match_kw("FIRST"):
                location = "FIRST"
            elif self.match_kw("AFTER"):
                location = f"AFTER {self.parse_identifier()}"
            return AlterTable(table, AddColumn(col, location))
        if self.match_kw("DROP"):
            self.match_kw("COLUMN")
            return AlterTable(table, DropColumn(self.parse_identifier()))
        if self.match_kw("RENAME"):
            self.match_kw("TO")
            return AlterTable(table, RenameTable(self.parse_identifier()))
        t = self.peek()
        raise ParserError(f"unsupported ALTER operation {t.value!r}")

    # ---- INSERT / DELETE ----
    def parse_insert(self) -> Insert:
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        table = self.parse_object_name()
        columns: List[str] = []
        if self.match_op("("):
            columns.append(self.parse_identifier())
            while self.match_op(","):
                columns.append(self.parse_identifier())
            self.expect_op(")")
        if self.at_kw("SELECT"):
            return Insert(table, columns, select=self.parse_query())
        self.expect_kw("VALUES")
        rows: List[List[Expr]] = []
        while True:
            row = self._fast_values_row()
            if row is None:
                self.expect_op("(")
                row = []
                if not (self.peek().kind == OP and
                        self.peek().value == ")"):
                    row.append(self.parse_expr())
                    while self.match_op(","):
                        row.append(self.parse_expr())
                self.expect_op(")")
            rows.append(row)
            if not self.match_op(","):
                break
        return Insert(table, columns, rows)

    def _fast_values_row(self) -> Optional[List[Expr]]:
        """Direct token walk for the all-literal VALUES tuple (the bulk
        INSERT hot path); bails to the expression grammar on anything
        fancier (functions, arithmetic, placeholders)."""
        toks = self.toks
        i = self.i
        t = toks[i]
        if not (t.kind == OP and t.value == "("):
            return None
        i += 1
        row: List[Expr] = []
        while True:
            t = toks[i]
            k = t.kind
            neg = False
            if k == OP and t.value in ("-", "+"):
                neg = t.value == "-"
                i += 1
                t = toks[i]
                k = t.kind
                if k != NUMBER:
                    return None
            if k == NUMBER:
                txt = t.value
                if txt.lower().startswith("0x"):
                    v = int(txt, 16)
                else:
                    v = float(txt) if ("." in txt or "e" in txt.lower()) \
                        else int(txt)
                row.append(Literal(-v if neg else v, "number"))
            elif k == STRING:
                row.append(Literal(t.value, "string"))
            elif k == IDENT:
                kw = t.value.upper()
                if kw == "NULL":
                    row.append(Literal(None, "null"))
                elif kw in ("TRUE", "FALSE"):
                    row.append(Literal(kw == "TRUE", "bool"))
                else:
                    return None
            else:
                return None
            i += 1
            t = toks[i]
            if t.kind == OP and t.value == ",":
                i += 1
                continue
            if t.kind == OP and t.value == ")":
                self.i = i + 1
                return row
            return None

    def parse_delete(self) -> Delete:
        self.expect_kw("DELETE")
        self.expect_kw("FROM")
        table = self.parse_object_name()
        where = None
        if self.match_kw("WHERE"):
            where = self.parse_expr()
        return Delete(table, where)

    # ---- SHOW ----
    def parse_show(self) -> Statement:
        self.expect_kw("SHOW")
        full = self.match_kw("FULL")
        if self.match_kw("DATABASES") or self.match_kw("SCHEMAS"):
            like, where = self._parse_show_filter()
            return ShowDatabases(like, where)
        if self.match_kw("TABLES"):
            database = None
            if self.match_kw("FROM") or self.match_kw("IN"):
                database = self.parse_identifier()
            like, where = self._parse_show_filter()
            return ShowTables(database, like, where, full)
        if self.match_kw("FLOWS"):
            like, where = self._parse_show_filter()
            if where is not None:
                raise ParserError("SHOW FLOWS supports LIKE, not WHERE")
            return ShowFlows(like)
        if self.match_kw("PROCESSLIST"):
            return ShowProcessList(full=full)
        if self.match_kw("CREATE"):
            self.expect_kw("TABLE")
            return ShowCreateTable(self.parse_object_name())
        # SHOW VARIABLES / SHOW <ident> — MySQL-compat surface
        rest = []
        while self.peek().kind != EOF and not (
                self.peek().kind == OP and self.peek().value == ";"):
            rest.append(self.next().value)
        return ShowVariable(" ".join(rest))

    def _parse_show_filter(self):
        like = where = None
        if self.match_kw("LIKE"):
            t = self.next()
            like = t.value
        elif self.match_kw("WHERE"):
            where = self.parse_expr()
        return like, where

    # ---- TQL ----
    def parse_tql(self) -> Tql:
        self.expect_kw("TQL")
        if self.match_kw("EVAL") or self.match_kw("EVALUATE"):
            kind = "eval"
        elif self.match_kw("EXPLAIN"):
            kind = "analyze" if self.match_kw("ANALYZE") else "explain"
        elif self.match_kw("ANALYZE"):
            kind = "analyze"
        else:
            raise ParserError("expected EVAL/EXPLAIN/ANALYZE after TQL")
        start, end, step, lookback = "0", "0", "5m", None
        if self.match_op("("):
            params = []
            depth = 1
            cur: List[str] = []
            while depth > 0:
                t = self.next()
                if t.kind == EOF:
                    raise ParserError("unterminated TQL parameter list")
                if t.kind == OP and t.value == "(":
                    depth += 1
                elif t.kind == OP and t.value == ")":
                    depth -= 1
                    if depth == 0:
                        break
                elif t.kind == OP and t.value == "," and depth == 1:
                    params.append("".join(cur))
                    cur = []
                    continue
                if t.kind == STRING:
                    cur.append(t.value)
                else:
                    cur.append(t.value)
            params.append("".join(cur))
            if len(params) < 3:
                raise ParserError(
                    f"TQL expects (start, end, step), got {len(params)} "
                    f"parameter(s)")
            start, end, step = params[0], params[1], params[2]
            if len(params) >= 4:
                lookback = params[3]
        # the rest of the statement (up to ;) is the raw PromQL text — sliced
        # from the source string so PromQL syntax never has to be valid SQL
        start_pos = self.peek().pos
        while self.peek().kind != EOF and not (
                self.peek().kind == OP and self.peek().value == ";"):
            self.next()
        end_pos = self.peek().pos if self.peek().kind != EOF else len(self.sql)
        query = self.sql[start_pos:end_pos].strip()
        return Tql(kind, start, end, step, lookback, query)

    # ---- COPY ----
    def parse_copy(self) -> Copy:
        self.expect_kw("COPY")
        table = self.parse_object_name()
        if self.match_kw("TO"):
            direction = "to"
        elif self.match_kw("FROM"):
            direction = "from"
        else:
            raise ParserError("expected TO or FROM in COPY")
        t = self.next()
        if t.kind != STRING:
            raise ParserError("expected file path string in COPY")
        options = {}
        if self.match_kw("WITH"):
            self.expect_op("(")
            options = self._parse_kv_list()
            self.expect_op(")")
        return Copy(table, direction, t.value, options)

    # ---- EXPLAIN / SET ----
    def parse_explain(self) -> Explain:
        self.expect_kw("EXPLAIN")
        analyze = self.match_kw("ANALYZE")
        verbose = self.match_kw("VERBOSE")
        return Explain(self.parse_statement(), analyze, verbose)

    def parse_set(self) -> SetVariable:
        self.expect_kw("SET")
        self.match_kw("SESSION") or self.match_kw("GLOBAL") or \
            self.match_kw("LOCAL")
        parts = [self.parse_identifier()]
        while self.match_op("."):
            parts.append(self.parse_identifier())
        if self.match_op("="):
            value = self._parse_set_value()
        elif self.match_kw("TO"):
            value = self._parse_set_value()
        else:
            value = None
        return SetVariable(".".join(parts), value)

    def _parse_set_value(self):
        neg = self.match_op("-")
        t = self.next()
        if t.kind == NUMBER:
            if "." in t.value or "e" in t.value.lower():
                v = float(t.value)
            else:
                v = self._to_int(t)
            return -v if neg else v
        if neg:
            raise ParserError(f"expected number after '-' at {t.pos}")
        return t.value


# --------------------------------------------------------------------------
# CTE inlining (parse_with): rewrite CTE references into derived tables
# --------------------------------------------------------------------------

def _inline_ctes(node, ctes: dict) -> None:
    """Replace every TableRef naming a CTE with a deep copy of the CTE's
    query as a derived table, recursing through set ops, joins, derived
    tables, and expression subqueries (EXISTS / IN / scalar)."""
    if not ctes:
        return
    import copy as _copy
    if isinstance(node, SetQuery):
        _inline_ctes(node.left, ctes)
        _inline_ctes(node.right, ctes)
        for e, _ in node.order_by:
            _inline_expr(e, ctes)
        return
    if not isinstance(node, Query):
        return
    for ref in [node.from_] + [j.table for j in node.joins]:
        if ref is None:
            continue
        if ref.subquery is not None:
            _inline_ctes(ref.subquery, ctes)
        elif (ref.name is not None and len(ref.name.parts) == 1
                and ref.name.table.lower() in ctes):
            cte_q = ctes[ref.name.table.lower()]
            ref.alias = ref.alias or ref.name.table
            ref.name = None
            ref.subquery = _copy.deepcopy(cte_q)
    for item in node.projections:
        _inline_expr(item.expr, ctes)
    for e in (node.where, node.having):
        if e is not None:
            _inline_expr(e, ctes)
    for e in node.group_by:
        _inline_expr(e, ctes)
    for e, _ in node.order_by:
        _inline_expr(e, ctes)
    for j in node.joins:
        if j.on is not None:
            _inline_expr(j.on, ctes)


def _inline_expr(e, ctes: dict) -> None:
    """Walk an expression tree, inlining CTEs inside embedded queries."""
    if isinstance(e, Subquery):
        _inline_ctes(e.query, ctes)
        return
    for v in vars(e).values():
        if isinstance(v, Expr):
            _inline_expr(v, ctes)
        elif isinstance(v, WindowSpec):
            for pe in v.partition_by:
                _inline_expr(pe, ctes)
            for oe, _ in v.order_by:
                _inline_expr(oe, ctes)
        elif isinstance(v, list):
            for x in v:
                if isinstance(x, Expr):
                    _inline_expr(x, ctes)
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, Expr):
                            _inline_expr(y, ctes)


def _apply_cte_column_aliases(q, cols: List[str], name: str) -> None:
    """WITH t(a, b) AS (...) renames the CTE's output columns: alias each
    branch's projections positionally (Postgres semantics)."""
    if isinstance(q, SetQuery):
        _apply_cte_column_aliases(q.left, cols, name)
        _apply_cte_column_aliases(q.right, cols, name)
        return
    if any(isinstance(p.expr, Star) for p in q.projections):
        raise ParserError(
            f"CTE {name!r}: a column list cannot rename SELECT *")
    if len(q.projections) != len(cols):
        raise ParserError(
            f"CTE {name!r} has {len(cols)} column names but its SELECT "
            f"returns {len(q.projections)} columns")
    for p, c in zip(q.projections, cols):
        p.alias = c
