"""PromQL parser: tokenizer + Pratt expression parser → promql.ast nodes.

Reference behavior: the reference consumes the `promql-parser` crate
(src/promql/src/planner.rs:70 takes its `EvalStmt`); this is an original
recursive-descent/Pratt implementation of the same grammar: vector/matrix
selectors with matchers, offset/@ modifiers, subqueries, functions,
aggregations with by/without (pre- or postfix), binary operators with
bool / on / ignoring / group_left / group_right modifiers, durations,
hex/float/inf/nan literals.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Tuple

from ..errors import GreptimeError
from .ast import (
    Aggregate, Binary, Call, Matcher, NumberLiteral, PromExpr, StringLiteral,
    SubqueryExpr, Unary, VectorMatching, VectorSelector,
)


class PromqlParseError(GreptimeError):
    status_code = "InvalidArguments"


AGGREGATORS = {
    "sum", "avg", "min", "max", "count", "stddev", "stdvar", "group",
    "topk", "bottomk", "quantile", "count_values",
}
# aggregators taking a parameter before the expression
PARAM_AGGREGATORS = {"topk", "bottomk", "quantile", "count_values"}

_DUR_RX = re.compile(
    r"(?:\d+(?:\.\d+)?(?:ms|s|m|h|d|w|y))+")


def parse_duration_ms(text: str) -> int:
    """'5m' / '1h30m' / '1.5h' → milliseconds (PromQL duration grammar,
    delegating to the shared common.time parser)."""
    from ..common.time import parse_duration_ms as _common_parse
    t = str(text).strip()
    if not t or not _DUR_RX.fullmatch(t):
        raise PromqlParseError(f"invalid duration {text!r}")
    try:
        return _common_parse(t)
    except ValueError as e:
        raise PromqlParseError(f"invalid duration {text!r}") from e


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

# token kinds: NUM DUR STR IDENT OP EOF
_NUM_RX = re.compile(
    r"0[xX][0-9a-fA-F]+|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")
_IDENT_RX = re.compile(r"[a-zA-Z_][a-zA-Z0-9_:]*")
_OPS = ["==", "!=", "<=", ">=", "=~", "!~", "+", "-", "*", "/", "%", "^",
        "<", ">", "=", "(", ")", "{", "}", "[", "]", ",", "@", ":"]


class _Tok:
    __slots__ = ("kind", "text", "pos")

    def __init__(self, kind, text, pos):
        self.kind, self.text, self.pos = kind, text, pos

    def __repr__(self):
        return f"{self.kind}:{self.text!r}"


def _tokenize(src: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "#":                       # comment to end of line
            while i < n and src[i] != "\n":
                i += 1
            continue
        if c in "'\"":
            j = i + 1
            buf = []
            while j < n and src[j] != c:
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    buf.append({"n": "\n", "t": "\t", "r": "\r",
                                "\\": "\\", "'": "'", '"': '"'}.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise PromqlParseError(f"unterminated string at {i}")
            toks.append(_Tok("STR", "".join(buf), i))
            i = j + 1
            continue
        if c == "`":
            j = src.find("`", i + 1)
            if j < 0:
                raise PromqlParseError(f"unterminated raw string at {i}")
            toks.append(_Tok("STR", src[i + 1:j], i))
            i = j + 1
            continue
        m = _DUR_RX.match(src, i)
        if m and not src[i].isalpha():
            # duration must not be a plain number: needs a unit suffix
            toks.append(_Tok("DUR", m.group(0), i))
            i = m.end()
            continue
        m = _NUM_RX.match(src, i)
        if m:
            toks.append(_Tok("NUM", m.group(0), i))
            i = m.end()
            continue
        m = _IDENT_RX.match(src, i)
        if m:
            toks.append(_Tok("IDENT", m.group(0), i))
            i = m.end()
            continue
        for op in _OPS:
            if src.startswith(op, i):
                toks.append(_Tok("OP", op, i))
                i += len(op)
                break
        else:
            raise PromqlParseError(f"unexpected character {c!r} at {i}")
    toks.append(_Tok("EOF", "", n))
    return toks


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

_PRECEDENCE = {
    "or": 1,
    "and": 2, "unless": 2,
    "==": 3, "!=": 3, "<": 3, "<=": 3, ">": 3, ">=": 3,
    "+": 4, "-": 4,
    "*": 5, "/": 5, "%": 5, "atan2": 5,
    "^": 6,
}
_RIGHT_ASSOC = {"^"}
_COMPARISONS = {"==", "!=", "<", "<=", ">", ">="}
_SET_OPS = {"and", "or", "unless"}


class _Parser:
    def __init__(self, src: str):
        self.toks = _tokenize(src)
        self.i = 0

    # -- token helpers --
    def peek(self) -> _Tok:
        return self.toks[self.i]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, text: Optional[str] = None) -> _Tok:
        t = self.peek()
        if t.kind != kind or (text is not None and t.text != text):
            want = text or kind
            raise PromqlParseError(
                f"expected {want!r}, got {t.text!r} at {t.pos}")
        return self.next()

    def at_op(self, text: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.text == text

    def at_ident(self, text: str) -> bool:
        t = self.peek()
        return t.kind == "IDENT" and t.text == text

    def eat_op(self, text: str) -> bool:
        if self.at_op(text):
            self.next()
            return True
        return False

    # -- grammar --
    def parse(self) -> PromExpr:
        e = self.parse_expr(0)
        t = self.peek()
        if t.kind != "EOF":
            raise PromqlParseError(
                f"unexpected {t.text!r} at {t.pos}")
        return e

    def parse_expr(self, min_prec: int) -> PromExpr:
        lhs = self.parse_unary()
        while True:
            t = self.peek()
            op = t.text if (
                t.kind == "OP" or (t.kind == "IDENT" and
                                   t.text in ("and", "or", "unless", "atan2"))
            ) else None
            if op not in _PRECEDENCE or _PRECEDENCE[op] < min_prec:
                return lhs
            self.next()
            return_bool = False
            if op in _COMPARISONS and self.at_ident("bool"):
                self.next()
                return_bool = True
            matching = self._parse_matching(op)
            nxt = _PRECEDENCE[op] + (0 if op in _RIGHT_ASSOC else 1)
            rhs = self.parse_expr(nxt)
            lhs = Binary(op=op, lhs=lhs, rhs=rhs, return_bool=return_bool,
                         matching=matching)

    def _parse_matching(self, op: str) -> Optional[VectorMatching]:
        if not (self.at_ident("on") or self.at_ident("ignoring")):
            return None
        kind = self.next().text
        labels = self._label_list()
        vm = VectorMatching(on=labels if kind == "on" else None,
                            ignoring=labels if kind == "ignoring" else None)
        if self.at_ident("group_left") or self.at_ident("group_right"):
            g = self.next().text
            if g == "group_left":
                vm.group_left = True
            else:
                vm.group_right = True
            if self.at_op("("):
                vm.include = self._label_list()
        if vm.on is None and vm.ignoring is None:
            vm.ignoring = []
        return vm

    def _label_list(self) -> List[str]:
        self.expect("OP", "(")
        out = []
        while not self.at_op(")"):
            out.append(self.expect("IDENT").text)
            if not self.eat_op(","):
                break
        self.expect("OP", ")")
        return out

    def parse_unary(self) -> PromExpr:
        if self.at_op("-") or self.at_op("+"):
            op = self.next().text
            # unary binds looser than ^ only (prometheus: -1^2 == -(1^2))
            e = self.parse_expr(_PRECEDENCE["^"])
            if op == "-":
                if isinstance(e, NumberLiteral):
                    return NumberLiteral(-e.value)
                return Unary(op="-", expr=e)
            return e
        return self.parse_postfix(self.parse_primary())

    def parse_postfix(self, e: PromExpr) -> PromExpr:
        while True:
            if self.at_op("["):
                self.next()
                rng = parse_duration_ms(self.expect("DUR").text)
                if self.eat_op(":"):          # subquery [range:step]
                    step = None
                    if self.peek().kind == "DUR":
                        step = parse_duration_ms(self.next().text)
                    self.expect("OP", "]")
                    e = SubqueryExpr(expr=e, range_ms=rng, step_ms=step)
                else:
                    self.expect("OP", "]")
                    if not isinstance(e, VectorSelector) or e.range_ms:
                        raise PromqlParseError(
                            "range can only follow a vector selector")
                    e.range_ms = rng
            elif self.at_ident("offset"):
                self.next()
                neg = self.eat_op("-")
                off = parse_duration_ms(self.expect("DUR").text)
                off = -off if neg else off
                tgt = e
                if isinstance(tgt, (VectorSelector, SubqueryExpr)):
                    tgt.offset_ms = off
                else:
                    raise PromqlParseError("offset must follow a selector")
            elif self.at_op("@"):
                self.next()
                t = self.peek()
                if t.kind == "IDENT" and t.text in ("start", "end"):
                    self.next()
                    self.expect("OP", "(")
                    self.expect("OP", ")")
                    at = "start" if t.text == "start" else "end"
                elif t.kind == "NUM" or (t.kind == "OP" and t.text == "-"):
                    neg = self.eat_op("-")
                    v = float(self.expect("NUM").text)
                    at = int((-v if neg else v) * 1000)
                else:
                    raise PromqlParseError(f"invalid @ modifier at {t.pos}")
                if isinstance(e, VectorSelector):
                    e.at_ms = at
                else:
                    raise PromqlParseError("@ must follow a selector")
            else:
                return e

    def parse_primary(self) -> PromExpr:
        t = self.peek()
        if t.kind == "NUM":
            self.next()
            txt = t.text
            if txt.lower().startswith("0x"):
                return NumberLiteral(float(int(txt, 16)))
            return NumberLiteral(float(txt))
        if t.kind == "DUR":
            # durations are valid number literals (e.g. `5m` = 300 in newer
            # prometheus); accept as seconds? keep strict: reject.
            raise PromqlParseError(
                f"unexpected duration {t.text!r} at {t.pos}")
        if t.kind == "STR":
            self.next()
            return StringLiteral(t.text)
        if self.at_op("("):
            self.next()
            e = self.parse_expr(0)
            self.expect("OP", ")")
            return e
        if self.at_op("{"):
            return self._vector_selector("")
        if t.kind == "IDENT":
            name = t.text
            low = name.lower()
            if low in ("inf", "nan") and name not in AGGREGATORS:
                self.next()
                return NumberLiteral(math.inf if low == "inf" else math.nan)
            if name in AGGREGATORS:
                nxt = self.toks[self.i + 1]
                if nxt.kind == "OP" and nxt.text == "(" or \
                        (nxt.kind == "IDENT" and
                         nxt.text in ("by", "without")):
                    return self._aggregate(name)
            nxt = self.toks[self.i + 1]
            if nxt.kind == "OP" and nxt.text == "(":
                self.next()
                return self._call(name)
            self.next()
            return self._vector_selector(name)
        raise PromqlParseError(f"unexpected {t.text!r} at {t.pos}")

    def _call(self, func: str) -> Call:
        self.expect("OP", "(")
        args: List[PromExpr] = []
        while not self.at_op(")"):
            args.append(self.parse_expr(0))
            if not self.eat_op(","):
                break
        self.expect("OP", ")")
        return Call(func=func, args=args)

    def _aggregate(self, op: str) -> Aggregate:
        self.next()                         # the aggregator ident
        by = without = None
        if self.at_ident("by") or self.at_ident("without"):
            kind = self.next().text
            labels = self._label_list()
            by, without = (labels, None) if kind == "by" else (None, labels)
        self.expect("OP", "(")
        args: List[PromExpr] = []
        while not self.at_op(")"):
            args.append(self.parse_expr(0))
            if not self.eat_op(","):
                break
        self.expect("OP", ")")
        if self.at_ident("by") or self.at_ident("without"):
            kind = self.next().text
            labels = self._label_list()
            by, without = (labels, None) if kind == "by" else (None, labels)
        param = None
        if op in PARAM_AGGREGATORS:
            if len(args) != 2:
                raise PromqlParseError(f"{op} expects (param, expr)")
            param, expr = args
        else:
            if len(args) != 1:
                raise PromqlParseError(f"{op} expects one argument")
            expr = args[0]
        return Aggregate(op=op, expr=expr, by=by, without=without,
                         param=param)

    def _vector_selector(self, metric: str) -> VectorSelector:
        matchers: List[Matcher] = []
        if self.at_op("{"):
            self.next()
            while not self.at_op("}"):
                name = self.expect("IDENT").text
                t = self.peek()
                if t.kind != "OP" or t.text not in ("=", "!=", "=~", "!~"):
                    raise PromqlParseError(
                        f"expected matcher op at {t.pos}")
                self.next()
                value = self.expect("STR").text
                matchers.append(Matcher(name, t.text, value))
                if not self.eat_op(","):
                    break
            self.expect("OP", "}")
        if not metric:
            for m in matchers:
                if m.name == "__name__" and m.op == "=":
                    metric = m.value
            if not metric and not matchers:
                raise PromqlParseError("empty vector selector")
        return VectorSelector(metric=metric, matchers=matchers)


def parse_promql(src: str) -> PromExpr:
    if not src or not src.strip():
        raise PromqlParseError("empty query")
    return _Parser(src).parse()
