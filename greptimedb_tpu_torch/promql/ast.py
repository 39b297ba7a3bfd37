"""PromQL AST nodes (mirrors the prometheus parser's expression types that
the reference consumes via the promql-parser crate)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# matcher types
EQ, NEQ, RE, NRE = "=", "!=", "=~", "!~"


@dataclass
class Matcher:
    name: str
    op: str          # = != =~ !~
    value: str


@dataclass
class PromExpr:
    pass


@dataclass
class NumberLiteral(PromExpr):
    value: float


@dataclass
class StringLiteral(PromExpr):
    value: str


@dataclass
class VectorSelector(PromExpr):
    metric: str = ""
    matchers: List[Matcher] = field(default_factory=list)
    range_ms: Optional[int] = None       # matrix selector when set
    offset_ms: int = 0
    at_ms: Optional[int] = None          # @ modifier


@dataclass
class SubqueryExpr(PromExpr):
    expr: PromExpr = None
    range_ms: int = 0
    step_ms: Optional[int] = None
    offset_ms: int = 0


@dataclass
class Call(PromExpr):
    func: str = ""
    args: List[PromExpr] = field(default_factory=list)


@dataclass
class Aggregate(PromExpr):
    op: str = ""                          # sum avg min max count topk ...
    expr: PromExpr = None
    by: Optional[List[str]] = None        # by(...) labels
    without: Optional[List[str]] = None
    param: Optional[PromExpr] = None      # topk(k, ...) / quantile(q, ...)


@dataclass
class VectorMatching:
    on: Optional[List[str]] = None        # on(...) labels
    ignoring: Optional[List[str]] = None
    group_left: bool = False
    group_right: bool = False
    include: List[str] = field(default_factory=list)


@dataclass
class Binary(PromExpr):
    op: str = ""                          # + - * / % ^ == != < <= > >= and or unless atan2
    lhs: PromExpr = None
    rhs: PromExpr = None
    return_bool: bool = False
    matching: Optional[VectorMatching] = None


@dataclass
class Unary(PromExpr):
    op: str = "-"
    expr: PromExpr = None
