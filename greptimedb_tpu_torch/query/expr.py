"""Scalar SQL expression evaluation over columnar data (numpy/pandas).

This is the CPU fallback's evaluator and the filter/projection evaluator
shared with the TPU path's host-side pieces. Columns live in a pandas
DataFrame (nulls as NaN/None); expressions produce pandas Series (or python
scalars for constant folds).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import pandas as pd

from ..datatypes.data_type import parse_type_name
from ..errors import ColumnNotFoundError, PlanError, UnsupportedError
from ..sql.ast import (
    Between, BinaryOp, Case, Cast, Column, Expr, FunctionCall, InList,
    Interval, IsNull, Literal, Placeholder, Star, Subquery, UnaryOp,
)
from .functions import SCALAR_FUNCTIONS, now_ms, parse_interval_ms


def like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def expr_name(e: Expr) -> str:
    """Display/column name for an unaliased projection (DataFusion-style)."""
    if isinstance(e, Column):
        return e.name
    if isinstance(e, Star):
        return "*"
    if isinstance(e, FunctionCall):
        inner = ", ".join(expr_name(a) for a in e.args)
        if e.distinct:
            inner = "DISTINCT " + inner
        base = f"{e.name}({inner})"
        if e.over is not None:
            # distinct OVER specs are distinct expressions: the window
            # rewriter dedups by this name, and projections of two
            # windows of the same function must not collide
            return f"{base} OVER ({e.over})"
        return base
    if isinstance(e, Literal):
        return str(e)
    if isinstance(e, BinaryOp):
        return f"{expr_name(e.left)} {e.op.upper()} {expr_name(e.right)}"
    if isinstance(e, UnaryOp):
        return f"{e.op.upper()} {expr_name(e.operand)}" if e.op == "not" \
            else f"{e.op}{expr_name(e.operand)}"
    if isinstance(e, Cast):
        return f"CAST({expr_name(e.expr)} AS {e.type_name})"
    if isinstance(e, IsNull):
        return f"{expr_name(e.expr)} IS {'NOT ' if e.negated else ''}NULL"
    return type(e).__name__.lower()


class Evaluator:
    def __init__(self, df: pd.DataFrame, params: Optional[Dict[int, Any]] = None):
        self.df = df
        self.params = params or {}
        self._now = now_ms()

    def series(self, value) -> pd.Series:
        """Broadcast a scalar result to a column aligned with the frame's
        index (the frame may be a WHERE-filtered view with gaps)."""
        if isinstance(value, pd.Series):
            return value
        return pd.Series([value] * len(self.df), index=self.df.index)

    def eval(self, e: Expr):
        if isinstance(e, Literal):
            return e.value
        if isinstance(e, Column):
            key = e.name
            if e.table and f"{e.table}.{e.name}" in self.df.columns:
                # joined frames carry alias-qualified columns
                return self.df[f"{e.table}.{e.name}"]
            if key not in self.df.columns:
                # case-insensitive fallback (MySQL compat)
                lowered = {c.lower(): c for c in self.df.columns}
                if key.lower() in lowered:
                    key = lowered[key.lower()]
                else:
                    raise ColumnNotFoundError(f"column {e.name!r} not found")
            return self.df[key]
        if isinstance(e, Interval):
            return parse_interval_ms(e.text)
        if isinstance(e, Placeholder):
            if e.index not in self.params:
                raise PlanError(f"unbound placeholder ?{e.index}")
            return self.params[e.index]
        if isinstance(e, UnaryOp):
            v = self.eval(e.operand)
            if e.op == "not":
                return self._negate(self._as_bool(v))
            if e.op == "-":
                return -self._num(v)
            return v
        if isinstance(e, BinaryOp):
            return self._binary(e)
        if isinstance(e, Between):
            v = self._num_or_raw(self.eval(e.expr))
            lo = self.eval(e.low)
            hi = self.eval(e.high)
            out = (v >= lo) & (v <= hi)
            return self._negate(self._as_bool(out)) if e.negated else out
        if isinstance(e, InList):
            if any(isinstance(i, Subquery) for i in e.items):
                raise UnsupportedError("IN (subquery) is not supported yet")
            v = self.eval(e.expr)
            items = [self.eval(i) for i in e.items]
            s = v if isinstance(v, pd.Series) else self.series(v)
            out = s.isin(items)
            return ~out if e.negated else out
        if isinstance(e, IsNull):
            v = self.eval(e.expr)
            s = v if isinstance(v, pd.Series) else self.series(v)
            out = s.isna()
            return ~out if e.negated else out
        if isinstance(e, Cast):
            return self._cast(self.eval(e.expr), e.type_name)
        if isinstance(e, Case):
            return self._case(e)
        if isinstance(e, FunctionCall):
            return self._call(e)
        if isinstance(e, Star):
            raise PlanError("'*' is only valid as a projection or in count(*)")
        if isinstance(e, Subquery):
            raise UnsupportedError("scalar subqueries are not supported yet")
        raise UnsupportedError(f"cannot evaluate {type(e).__name__}")

    # ---- helpers ----
    def _as_bool(self, v):
        if isinstance(v, pd.Series):
            return v.fillna(False).astype(bool)
        return bool(v)

    @staticmethod
    def _negate(b):
        """Boolean NOT that is safe for scalars: ~True is -2 (truthy!),
        so Python bools must use `not`, Series use `~`."""
        return ~b if isinstance(b, pd.Series) else (not b)

    def _num(self, v):
        return v

    def _num_or_raw(self, v):
        return v

    def _binary(self, e: BinaryOp):
        op = e.op
        if op in ("and", "or"):
            l = self._as_bool(self.eval(e.left))
            r = self._as_bool(self.eval(e.right))
            return (l & r) if op == "and" else (l | r)
        l = self.eval(e.left)
        r = self.eval(e.right)
        if op in ("like", "ilike", "regexp"):
            if not isinstance(r, str):
                raise PlanError(f"{op.upper()} pattern must be a string")
            pattern = like_to_regex(r) if op in ("like", "ilike") else r
            flags = re.IGNORECASE if op == "ilike" else 0
            s = l if isinstance(l, pd.Series) else self.series(l)
            return s.astype("string").str.match(pattern, flags=flags,
                                                na=False).astype(bool)
        if op == "||":
            ls = l if isinstance(l, pd.Series) else self.series(l)
            return ls.astype("string") + pd.Series(r).astype("string")[0] \
                if not isinstance(r, pd.Series) \
                else ls.astype("string") + r.astype("string")
        try:
            if op == "=":
                return l == r
            if op == "!=":
                return l != r
            if op == "<":
                return l < r
            if op == "<=":
                return l <= r
            if op == ">":
                return l > r
            if op == ">=":
                return l >= r
            if op == "+":
                return l + r
            if op == "-":
                return l - r
            if op == "*":
                return l * r
            if op == "/":
                return self._div(l, r)
            if op == "%":
                return l % r
        except TypeError as err:
            raise PlanError(f"type error in {op!r}: {err}") from err
        raise UnsupportedError(f"operator {op!r}")

    def _div(self, l, r):
        with np.errstate(divide="ignore", invalid="ignore"):
            lv = l.astype(np.float64) if isinstance(l, pd.Series) else float(l)
            rv = r.astype(np.float64) if isinstance(r, pd.Series) else float(r)
            return lv / rv

    def _cast(self, v, type_name: str):
        """SQL CAST semantics: NULL in → NULL out for every target type
        (pandas astype would either raise on NaN→int or coerce NaN→True
        for bool), and invalid literals surface as taxonomy errors."""
        from ..errors import InvalidArgumentsError
        tn = type_name.strip().lower()
        try:
            if tn in ("date", "timestamp", "datetime"):
                if isinstance(v, pd.Series):
                    dtv = pd.to_datetime(v, utc=True)
                    return dtv.map(
                        lambda x: None if pd.isna(x)
                        else int(x.value // 1_000_000))
                return int(pd.Timestamp(v, tz="UTC").value // 1_000_000)
            dtype = parse_type_name(type_name)
            if isinstance(v, pd.Series):
                if dtype.is_string:
                    return v.astype("string")
                kind = np.dtype(dtype.np_dtype).kind \
                    if dtype.np_dtype is not None else "O"
                if kind in "iu" and v.dtype.kind in "fO":
                    # float→int CAST rounds (Postgres semantics), and the
                    # same way whether or not the column holds NULLs
                    num = pd.to_numeric(v)
                    if num.isna().any():
                        return num.map(
                            lambda x: None if pd.isna(x)
                            else int(round(float(x))))
                    return np.rint(num.to_numpy(np.float64)) \
                        .astype(dtype.np_dtype)
                if kind == "b" and v.isna().any():
                    return v.map(lambda x: None if pd.isna(x)
                                 else bool(x))
                return v.astype(dtype.np_dtype)
            return dtype.cast_value(v) if v is not None else None
        except (ValueError, TypeError, OverflowError) as err:
            raise InvalidArgumentsError(
                f"cannot cast value to {type_name}: {err}") from None

    def _case(self, e: Case):
        idx = self.df.index
        result = pd.Series([None] * len(idx), dtype=object, index=idx)
        decided = pd.Series([False] * len(idx), index=idx)
        for cond, value in e.whens:
            if e.operand is not None:
                c = self.eval(BinaryOp("=", e.operand, cond)) \
                    if not isinstance(cond, Expr) else \
                    self._as_bool(self.series(self.eval(e.operand))
                                  == self.series(self.eval(cond)))
            else:
                c = self._as_bool(self.series(self.eval(cond)))
            c = self.series(c).fillna(False).astype(bool)
            take = c & ~decided
            v = self.series(self.eval(value))
            result[take] = v[take]
            decided |= take
        if e.else_ is not None:
            v = self.series(self.eval(e.else_))
            result[~decided] = v[~decided]
        return result.infer_objects()

    def _call(self, e: FunctionCall):
        name = e.name
        if name == "now" or name == "current_timestamp":
            return self._now
        if name in SCALAR_FUNCTIONS:
            args = [self.eval(a) for a in e.args]
            np_args = [a.to_numpy() if isinstance(a, pd.Series) else a
                       for a in args]
            out = SCALAR_FUNCTIONS[name](*np_args)
            if isinstance(out, np.ndarray) and len(self.df):
                return pd.Series(out, index=self.df.index)
            return out
        from .functions import UDF_REGISTRY
        if name in UDF_REGISTRY:
            args = [self.eval(a) for a in e.args]
            np_args = [a.to_numpy() if isinstance(a, pd.Series) else a
                       for a in args]
            out = UDF_REGISTRY[name](*np_args)
            if isinstance(out, np.ndarray) and len(self.df) and \
                    len(out) == len(self.df):
                return pd.Series(out, index=self.df.index)
            return out
        raise UnsupportedError(f"unknown function {name!r}")
