"""Query analysis: classify a parsed SELECT and extract aggregate structure.

The analog of the reference's logical planning (sqlparser AST → DataFusion
LogicalPlan via src/query/src/planner.rs): here the AST is analyzed into an
`Analysis` that either the TPU executor (tpu_exec.py) or the CPU fallback
(engine.py) runs. Aggregate calls inside projections/HAVING/ORDER BY are
rewritten to slot references so post-aggregation expressions evaluate over
the grouped frame.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..errors import PlanError, UnsupportedError
from ..sql.ast import (
    Between, BinaryOp, Case, Cast, Column, Expr, FunctionCall, InList,
    IsNull, Literal, Query, SelectItem, Star, Subquery, UnaryOp, WindowSpec,
)
from .expr import expr_name
from .functions import AGGREGATE_FUNCTIONS

AGG_NAMES = set(AGGREGATE_FUNCTIONS) | {"first", "last", "first_value",
                                        "last_value"}
_AGG_CANON = {"mean": "avg", "first_value": "first", "last_value": "last"}

#: ranking / navigation functions valid only with OVER
WINDOW_ONLY_NAMES = {"row_number", "rank", "dense_rank", "percent_rank",
                     "cume_dist", "ntile", "lag", "lead", "first_value",
                     "last_value"}
#: aggregates that may also run as window functions
WINDOW_AGG_NAMES = {"sum", "avg", "mean", "min", "max", "count", "stddev",
                    "variance"}


@dataclass
class AggCall:
    op: str                       # canonical op name
    arg: Optional[Expr]           # None for count(*)
    distinct: bool = False
    params: Tuple = ()            # literal extras (percentile p, ...)
    slot: str = ""                # column name in the grouped frame

    @property
    def is_count_star(self) -> bool:
        return self.op == "count" and self.arg is None


@dataclass
class WindowCall:
    """One windowed function: computed over the (post-agg) result frame and
    exposed to projections as `slot` (mirrors DataFusion's WindowExpr)."""
    op: str                       # lowercase function name (mean→avg)
    args: List[Expr] = field(default_factory=list)
    spec: WindowSpec = field(default_factory=WindowSpec)
    slot: str = ""


@dataclass
class Analysis:
    query: Query
    projections: List[SelectItem] = field(default_factory=list)  # rewritten
    group_exprs: List[Expr] = field(default_factory=list)
    agg_calls: List[AggCall] = field(default_factory=list)
    window_calls: List[WindowCall] = field(default_factory=list)
    having: Optional[Expr] = None                                # rewritten
    order_by: List[Tuple[Expr, bool]] = field(default_factory=list)
    column_refs: List[str] = field(default_factory=list)

    @property
    def is_aggregate(self) -> bool:
        return bool(self.agg_calls) or bool(self.group_exprs)


def _walk_columns(e: Expr, out: set) -> None:
    if isinstance(e, Column):
        out.add(e.name)
    for attr in ("left", "right", "operand", "expr", "low", "high"):
        child = getattr(e, attr, None)
        if isinstance(child, Expr):
            _walk_columns(child, out)
    if isinstance(e, FunctionCall):
        for a in e.args:
            _walk_columns(a, out)
        if e.over is not None:
            for p in e.over.partition_by:
                _walk_columns(p, out)
            for oe, _ in e.over.order_by:
                _walk_columns(oe, out)
    if isinstance(e, InList):
        for a in e.items:
            _walk_columns(a, out)
    if isinstance(e, Case):
        if e.operand:
            _walk_columns(e.operand, out)
        for c, v in e.whens:
            _walk_columns(c, out)
            _walk_columns(v, out)
        if e.else_:
            _walk_columns(e.else_, out)


def map_expr_children(e: Expr, f) -> Expr:
    """Rebuild e with f applied to each child expression."""
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, f(e.left), f(e.right))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, f(e.operand))
    if isinstance(e, Cast):
        return Cast(f(e.expr), e.type_name)
    if isinstance(e, Between):
        return Between(f(e.expr), f(e.low), f(e.high), e.negated)
    if isinstance(e, InList):
        return InList(f(e.expr), [f(i) for i in e.items], e.negated)
    if isinstance(e, IsNull):
        return IsNull(f(e.expr), e.negated)
    if isinstance(e, Case):
        return Case(
            f(e.operand) if e.operand else None,
            [(f(c), f(v)) for c, v in e.whens],
            f(e.else_) if e.else_ else None)
    if isinstance(e, FunctionCall):
        return FunctionCall(e.name, [f(a) for a in e.args], e.distinct,
                            e.over)
    return e


class _WindowRewriter:
    """Replaces windowed FunctionCalls with slot Columns, collecting calls."""

    def __init__(self):
        self.calls: List[WindowCall] = []
        self._seen: Dict[str, str] = {}

    def rewrite(self, e: Expr) -> Expr:
        if isinstance(e, FunctionCall) and e.over is not None:
            key = expr_name(e)
            if key in self._seen:
                return Column(self._seen[key])
            op = "avg" if e.name == "mean" else e.name
            if op not in WINDOW_ONLY_NAMES and op not in WINDOW_AGG_NAMES:
                raise UnsupportedError(f"window function {op!r}")
            if e.distinct:
                raise UnsupportedError("DISTINCT in window functions")
            for a in e.args:
                if _contains_window(a):
                    raise PlanError("nested window functions")
            args = list(e.args)
            if args and isinstance(args[0], Star):
                if op != "count":
                    raise PlanError(f"{op}(*) is not valid")
                args = []        # count(*) counts frame rows
            slot = f"__win{len(self.calls)}"
            self.calls.append(WindowCall(op=op, args=args,
                                         spec=e.over, slot=slot))
            self._seen[key] = slot
            return Column(slot)
        return map_expr_children(e, self.rewrite)


def _contains_window(e: Expr) -> bool:
    if isinstance(e, FunctionCall) and e.over is not None:
        return True
    if isinstance(e, FunctionCall):
        return any(_contains_window(a) for a in e.args)
    for attr in ("left", "right", "operand", "expr", "low", "high"):
        child = getattr(e, attr, None)
        if isinstance(child, Expr) and _contains_window(child):
            return True
    if isinstance(e, InList):
        return any(_contains_window(i) for i in e.items)
    if isinstance(e, Case):
        parts = ([e.operand] if e.operand else []) + \
            [x for cv in e.whens for x in cv] + \
            ([e.else_] if e.else_ else [])
        return any(_contains_window(p) for p in parts)
    return False


class _AggRewriter:
    """Replaces aggregate FunctionCalls with slot Columns, collecting calls."""

    def __init__(self):
        self.calls: List[AggCall] = []
        self._seen: Dict[str, str] = {}

    def rewrite(self, e: Expr) -> Expr:
        if isinstance(e, FunctionCall) and e.name in AGG_NAMES \
                and e.over is None:
            key = expr_name(e)
            if key in self._seen:
                return Column(self._seen[key])
            op = _AGG_CANON.get(e.name, e.name)
            arg: Optional[Expr] = None
            params: Tuple = ()
            if e.args and isinstance(e.args[0], Star):
                if op != "count":
                    raise PlanError(f"{op}(*) is not valid")
            elif e.args:
                arg = self.rewrite_inner_check(e.args[0])
                params = tuple(a.value for a in e.args[1:]
                               if isinstance(a, Literal))
            elif op != "count":
                raise PlanError(f"{op}() needs an argument")
            slot = f"__agg{len(self.calls)}"
            call = AggCall(op=op, arg=arg, distinct=e.distinct,
                           params=params, slot=slot)
            self.calls.append(call)
            self._seen[key] = slot
            return Column(slot)
        return map_expr_children(e, self.rewrite)

    def rewrite_inner_check(self, e: Expr) -> Expr:
        if isinstance(e, FunctionCall) and e.name in AGG_NAMES \
                and e.over is None:
            raise PlanError("nested aggregate functions are not allowed")
        return e


def contains_aggregate(e: Expr) -> bool:
    if isinstance(e, FunctionCall) and e.name in AGG_NAMES \
            and e.over is None:
        return True
    if isinstance(e, FunctionCall):
        return any(contains_aggregate(a) for a in e.args)
    for attr in ("left", "right", "operand", "expr", "low", "high"):
        child = getattr(e, attr, None)
        if isinstance(child, Expr) and contains_aggregate(child):
            return True
    if isinstance(e, InList):
        return any(contains_aggregate(i) for i in e.items)
    if isinstance(e, Case):
        parts = ([e.operand] if e.operand else []) + \
            [x for cv in e.whens for x in cv] + \
            ([e.else_] if e.else_ else [])
        return any(contains_aggregate(p) for p in parts)
    return False


def analyze(query: Query) -> Analysis:
    """Resolve GROUP BY / ORDER BY ordinals+aliases and extract aggregates."""
    a = Analysis(query=query)
    alias_map: Dict[str, Expr] = {}
    for item in query.projections:
        if item.alias:
            alias_map[item.alias.lower()] = item.expr

    def resolve_ref(e: Expr) -> Expr:
        if isinstance(e, Literal) and isinstance(e.value, int):
            idx = e.value - 1
            if not (0 <= idx < len(query.projections)):
                raise PlanError(f"ordinal {e.value} out of range")
            return query.projections[idx].expr
        if isinstance(e, Column) and e.table is None and \
                e.name.lower() in alias_map:
            return alias_map[e.name.lower()]
        return e

    a.group_exprs = [resolve_ref(g) for g in query.group_by]
    for g in a.group_exprs:
        if contains_aggregate(g):
            raise PlanError("aggregate functions are not allowed in GROUP BY")

    for e in ([query.where] if query.where is not None else []) + \
            list(query.group_by) + \
            ([query.having] if query.having is not None else []):
        if _contains_window(e):
            raise PlanError("window functions are only allowed in the "
                            "SELECT list and ORDER BY")

    rw = _AggRewriter()
    wrw = _WindowRewriter()
    group_names = {expr_name(g) for g in a.group_exprs}

    def rewrite_top(e: Expr) -> Expr:
        # a projection identical to a group expr passes through
        if expr_name(e) in group_names:
            return Column(_group_slot(expr_name(e)))
        return rw.rewrite(wrw.rewrite(e))

    a.projections = []
    for item in query.projections:
        if isinstance(item.expr, Star):
            a.projections.append(item)
            continue
        # keep the pre-rewrite display name: `avg(cpu)` not `__agg0`
        alias = item.alias or expr_name(item.expr)
        a.projections.append(SelectItem(rewrite_top(item.expr), alias))
    if query.having is not None:
        a.having = rewrite_top(query.having)
    a.order_by = []
    for e, asc in query.order_by:
        e = resolve_ref(e)
        a.order_by.append((rewrite_top(e)
                           if (rw.calls or a.group_exprs or wrw.calls
                               or _contains_window(e))
                           else e, asc))
    a.agg_calls = rw.calls
    a.window_calls = wrw.calls
    # window args / PARTITION BY / ORDER BY may reference aggregates in a
    # grouped query (e.g. rank() OVER (ORDER BY sum(v) DESC)) — rewrite
    # them to agg slots so they evaluate over the grouped frame
    for wc in a.window_calls:
        wc.args = [rewrite_top(x) for x in wc.args]
        wc.spec = WindowSpec(
            [rewrite_top(x) for x in wc.spec.partition_by],
            [(rewrite_top(x), asc) for x, asc in wc.spec.order_by],
            wc.spec.frame)

    refs: set = set()
    for item in query.projections:
        if not isinstance(item.expr, Star):
            _walk_columns(item.expr, refs)
    for g in query.group_by:
        _walk_columns(g, refs)
    if query.where is not None:
        _walk_columns(query.where, refs)
    if query.having is not None:
        _walk_columns(query.having, refs)
    for e, _ in query.order_by:
        _walk_columns(e, refs)
    a.column_refs = sorted(refs)

    if a.is_aggregate:
        star = [p for p in a.projections if isinstance(p.expr, Star)]
        if star:
            raise PlanError("'*' projection is not valid with GROUP BY")
    return a


def _group_slot(name: str) -> str:
    return f"__key__{name}"


def convert_time_literals(e: Optional[Expr], schema) -> Optional[Expr]:
    """String/second-precision literals compared against timestamp columns
    are coerced to the column's native unit (reference: TypeConversionRule
    analyzer, src/query/src/optimizer.rs:33 — DataFusion literals become
    timestamps before planning)."""
    if e is None or schema is None:
        return e

    def ts_unit(col: Expr):
        if isinstance(col, Column) and schema.contains(col.name):
            dtype = schema.column_schema(col.name).dtype
            if dtype.is_timestamp:
                return dtype.time_unit
        return None

    def coerce(lit: Expr, unit):
        if isinstance(lit, Literal) and isinstance(lit.value, str):
            from ..common.time import Timestamp
            try:
                return Literal(Timestamp.from_str(lit.value, unit).value)
            except (ValueError, TypeError):
                return lit
        return lit

    def walk(node: Expr) -> Expr:
        if isinstance(node, BinaryOp):
            if node.op in ("=", "!=", "<>", "<", "<=", ">", ">="):
                unit = ts_unit(node.left)
                if unit is not None:
                    return dataclasses.replace(
                        node, right=coerce(node.right, unit))
                unit = ts_unit(node.right)
                if unit is not None:
                    return dataclasses.replace(
                        node, left=coerce(node.left, unit))
                return node
            return dataclasses.replace(node, left=walk(node.left),
                                       right=walk(node.right))
        if isinstance(node, UnaryOp):
            return dataclasses.replace(node, operand=walk(node.operand))
        if isinstance(node, Between):
            unit = ts_unit(node.expr)
            if unit is not None:
                return dataclasses.replace(node, low=coerce(node.low, unit),
                                           high=coerce(node.high, unit))
            return node
        if isinstance(node, InList):
            unit = ts_unit(node.expr)
            if unit is not None:
                return dataclasses.replace(
                    node, items=[coerce(i, unit) for i in node.items])
            return node
        return node

    return walk(e)
