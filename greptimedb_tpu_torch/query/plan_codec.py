"""Plan shipping: TPU aggregate plans (and the expression subset they
carry) as JSON-safe dicts.

Reference: greptimedb_tpu/query/plan_codec.py, whose output this matches
byte for byte, expression columns (`field_exprs`) and sketch parameters
(`agg_params`) included. Decoding validates every moment and final op
against what this build's reducers implement and fails closed: an op
this build predates raises UnsupportedError (with
WIRE_UNSUPPORTED_MARKER), never a half-understood fold. Scan fusion
fingerprints plans through `plan_to_dict` (tpu_exec._ScanFlightMap), so
two plans that differ only in an expression or a percentile never fuse.
"""

from __future__ import annotations

from typing import Optional

from ..errors import UnsupportedError
from ..sql.ast import (
    Between, BinaryOp, Column, Expr, FunctionCall, InList, Interval, IsNull,
    Literal, UnaryOp,
)
from .tpu_exec import BucketGroup, FieldFilter, Moment, TagGroup, TpuPlan

#: every moment op this build's reducers implement, and every final op
#: _finalize renders
KNOWN_MOMENT_OPS = frozenset({
    "sum", "sum_sq", "count", "min", "max", "first", "last",
    "min_ts", "max_ts", "distinct", "tdigest", "reset_corr"})
KNOWN_FINAL_OPS = frozenset({
    "sum", "avg", "count", "min", "max", "first", "last", "stddev",
    "variance", "approx_distinct", "approx_percentile",
    "moment"})

#: substring marker that survives a wire's string-flattened errors
WIRE_UNSUPPORTED_MARKER = "unsupported shipped plan"


def expr_to_dict(e: Optional[Expr]) -> Optional[dict]:
    if e is None:
        return None
    if isinstance(e, Literal):
        return {"k": "lit", "v": e.value}
    if isinstance(e, Column):
        return {"k": "col", "name": e.name}
    if isinstance(e, BinaryOp):
        return {"k": "bin", "op": e.op, "l": expr_to_dict(e.left),
                "r": expr_to_dict(e.right)}
    if isinstance(e, UnaryOp):
        return {"k": "un", "op": e.op, "e": expr_to_dict(e.operand)}
    if isinstance(e, InList):
        return {"k": "in", "e": expr_to_dict(e.expr), "neg": e.negated,
                "items": [expr_to_dict(i) for i in e.items]}
    if isinstance(e, Between):
        return {"k": "between", "e": expr_to_dict(e.expr),
                "neg": e.negated, "lo": expr_to_dict(e.low),
                "hi": expr_to_dict(e.high)}
    if isinstance(e, IsNull):
        return {"k": "isnull", "e": expr_to_dict(e.expr), "neg": e.negated}
    if isinstance(e, FunctionCall):
        return {"k": "fn", "name": e.name,
                "args": [expr_to_dict(a) for a in e.args]}
    if isinstance(e, Interval):
        return {"k": "interval", "text": e.text}
    raise UnsupportedError(f"cannot ship expression {type(e).__name__}")


def expr_from_dict(d: Optional[dict]) -> Optional[Expr]:
    if d is None:
        return None
    k = d["k"]
    if k == "lit":
        return Literal(d["v"])
    if k == "col":
        return Column(d["name"])
    if k == "bin":
        return BinaryOp(d["op"], expr_from_dict(d["l"]),
                        expr_from_dict(d["r"]))
    if k == "un":
        return UnaryOp(d["op"], expr_from_dict(d["e"]))
    if k == "in":
        return InList(expr_from_dict(d["e"]),
                      [expr_from_dict(i) for i in d["items"]], d["neg"])
    if k == "between":
        return Between(expr_from_dict(d["e"]), expr_from_dict(d["lo"]),
                       expr_from_dict(d["hi"]), d["neg"])
    if k == "isnull":
        return IsNull(expr_from_dict(d["e"]), d["neg"])
    if k == "fn":
        return FunctionCall(d["name"],
                            [expr_from_dict(a) for a in d["args"]])
    if k == "interval":
        return Interval(d["text"])
    raise UnsupportedError(f"unknown shipped expression kind {k!r}")


def plan_to_dict(plan: TpuPlan) -> dict:
    return {
        "tag_groups": [{"name": t.name, "tag_index": t.tag_index}
                       for t in plan.tag_groups],
        "bucket": None if plan.bucket is None else {
            "stride_ms": plan.bucket.stride_ms,
            "origin": plan.bucket.origin,
            "expr_key": plan.bucket.expr_key},
        "moments": [{"op": m.op, "column": m.column, "slot": m.slot}
                    for m in plan.moments],
        "finals": [[slot, op, list(mslots)]
                   for slot, op, mslots in plan.finals],
        "time_lo": plan.time_lo,
        "time_hi": plan.time_hi,
        "tag_predicates": [expr_to_dict(p) for p in plan.tag_predicates],
        "field_filters": [{"column": f.column, "op": f.op,
                           "value": f.value}
                          for f in plan.field_filters],
        # expression-argument moments and sketch finals: virtual moment
        # columns each region evaluates from its stored fields, and
        # per-final literal params (approx_percentile's p)
        "field_exprs": {k: expr_to_dict(e)
                        for k, e in plan.field_exprs.items()},
        "agg_params": {k: list(v) for k, v in plan.agg_params.items()},
    }


def plan_from_dict(d: dict) -> TpuPlan:
    for m in d["moments"]:
        if m["op"] not in KNOWN_MOMENT_OPS:
            raise UnsupportedError(
                f"{WIRE_UNSUPPORTED_MARKER}: moment op {m['op']!r} "
                f"(this build predates it)")
    for _slot, op, _mslots in d["finals"]:
        if op not in KNOWN_FINAL_OPS:
            raise UnsupportedError(
                f"{WIRE_UNSUPPORTED_MARKER}: final op {op!r} "
                f"(this build predates it)")
    return TpuPlan(
        tag_groups=[TagGroup(t["name"], t["tag_index"])
                    for t in d["tag_groups"]],
        bucket=None if d["bucket"] is None else BucketGroup(
            d["bucket"]["stride_ms"], d["bucket"]["origin"],
            d["bucket"]["expr_key"]),
        moments=[Moment(m["op"], m["column"], m["slot"])
                 for m in d["moments"]],
        finals=[(slot, op, list(mslots)) for slot, op, mslots in
                d["finals"]],
        time_lo=d["time_lo"],
        time_hi=d["time_hi"],
        tag_predicates=[expr_from_dict(p) for p in d["tag_predicates"]],
        field_filters=[FieldFilter(f["column"], f["op"], f["value"])
                       for f in d["field_filters"]],
        field_exprs={k: expr_from_dict(e)
                     for k, e in (d.get("field_exprs") or {}).items()},
        agg_params={k: tuple(v)
                    for k, v in (d.get("agg_params") or {}).items()},
    )
