"""PromQL → plan-IR lowering, plus the engine's sanctioned data access.

Reference behavior: src/promql/src/planner.rs lowers PromQL into the
same DataFusion LogicalPlan SQL uses, so PromQL range queries ride
every pushdown the SQL optimizer knows. This module (the port of
greptimedb_tpu/promql/lowering.py) is the equivalent seam:
aggregate-over-selector shapes lower into the shared plan IR
(query/ir.py) and execute through the one aggregate executor —
cost-based scatter on DistTables, resident / streamed-cold /
indexed-point dispatch on a local table's regions, on the engine's
device — while every non-lowerable shape keeps the row path behind the
same selector, fed over the wire by an IR `RawScan` on DistTables.

This is also the only module under promql/ that touches region
internals (`table.regions`, the scan cache, merged region reads), so
every byte the PromQL engine reads flows through `select_series` or the
lowered plan.

Lowered shapes (everything else → row path):

  agg(selector)                 agg ∈ sum/avg/min/max/count [by/without]
  agg(fn(selector[R]))          fn ∈ rate/increase/delta/
                                sum|count|avg|min|max|last_over_time,
                                and the window tumbles (R == step)

with plain equality/inequality matchers on string tags, a single
numeric field, no @, and any offset. The inner selector/function is
rebuilt as a per-series instant vector from the finalized moment frame
(counter resets ride the host-only `reset_corr` moment; extrapolation
replicates ops/window.py exactly), then the engine's ordinary host
grouping aggregates it — outer semantics are shared with the row path by
construction.

A DistTable's lowered plans scatter through its aggregate pushdown (the
datanodes reduce on their own devices); its row path reads the selector by
an IR RawScan over the wire (`_wire_scan_selection`) and builds the
SeriesMatrix here, for the frontend's device. Where the port differs from
the reference: the wire scan's rows are labelled run by run
(`_label_wire_batches`: a run is a stretch of rows with equal tags, about
one a series since a region scans by series; matchers and labels are
evaluated once a run, series ids assigned per label tuple in first-seen
order), where the reference renders every row and field in a Python
loop. The labels, series ids, row order and matrix are the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import UnsupportedError
from ..sql.ast import BinaryOp, Column, IsNull, Literal
from .ast import Aggregate, Call, PromExpr, VectorSelector

#: outer aggregates whose inner vector we lower (topk/quantile/
#: count_values keep the row path: they need per-sample semantics the
#: moment frame cannot carry for arbitrary params)
LOWERABLE_AGG_OPS = frozenset({"sum", "avg", "min", "max", "count"})

#: range functions with an exact moment decomposition over one
#: tumbling window (range == step): value and ok-mask reconstruct
#: from first/last/min_ts/max_ts/count (+ reset_corr for counters)
LOWERABLE_RANGE_FUNCS = frozenset({
    "rate", "increase", "delta", "sum_over_time", "count_over_time",
    "avg_over_time", "min_over_time", "max_over_time", "last_over_time",
})

#: sentinel: the matchers statically match nothing — the lowered
#: answer is an empty vector, no scan needed
EMPTY = object()


@dataclass
class LoweredSelect:
    """One aggregate-over-selector shape lowered onto the plan IR."""
    table: object
    plan: object                       # query.ir TpuPlan
    func: Optional[str]                # None = instant selector
    metric: str
    field: str
    tag_names: List[str]
    t0: int                            # first window end (offset applied)
    ends: np.ndarray                   # [nsteps] window ends, int64
    win: int                           # window width (lookback or range)


def resolve_metric_table(engine, sel: VectorSelector, ctx):
    """(metric name, table or None) — shared by the lowering and the
    row path so both resolve `__name__` overrides identically."""
    metric = sel.metric
    for m in sel.matchers:
        if m.name == "__name__" and m.op == "=":
            metric = m.value
    if not metric:
        raise UnsupportedError(
            "selector without metric name is not supported")
    table = engine.catalog.table(ctx.current_catalog, ctx.current_schema,
                                 metric)
    return metric, table


def _numeric_fields(schema, matchers) -> List[str]:
    from .engine import _matcher_keep
    fields = [f for f in schema.field_names()
              if not schema.column_schema(f).dtype.is_string and
              not schema.column_schema(f).dtype.is_binary]
    for m in matchers:
        if m.name == "__field__":
            keep = _matcher_keep(fields, m)
            fields = [f for f, k in zip(fields, keep) if k]
    return fields


# ---------------------------------------------------------------------------
# shape analysis: Aggregate node -> LoweredSelect | EMPTY | None
# ---------------------------------------------------------------------------

def try_lower(ev, e: Aggregate):
    """Decide whether the inner vector of this aggregate lowers onto
    the IR. Returns (LoweredSelect, "") on success, (EMPTY, "") when
    the matchers statically match nothing, or (None, reason) when the
    statement keeps the row path."""
    from ..query import ir, tpu_exec
    from .engine import _matches_empty

    if e.op not in LOWERABLE_AGG_OPS or e.param is not None:
        return None, f"outer aggregate {e.op} keeps per-sample semantics"
    inner = e.expr
    func = None
    if isinstance(inner, Call):
        if inner.func not in LOWERABLE_RANGE_FUNCS or \
                len(inner.args) != 1 or \
                not isinstance(inner.args[0], VectorSelector):
            return None, f"function {getattr(inner, 'func', '?')} has " \
                "no moment decomposition"
        sel = inner.args[0]
        func = inner.func
        if not sel.range_ms:
            return None, f"{func} needs a range selector"
        if sel.range_ms != ev.step:
            return None, (f"window does not tumble "
                          f"(range={sel.range_ms}ms != step={ev.step}ms)")
    elif isinstance(inner, VectorSelector):
        sel = inner
        if sel.range_ms:
            return None, "raw matrix selector"
    else:
        return None, f"inner {type(inner).__name__} is not a selector"
    if sel.at_ms is not None:
        return None, "@ modifier pins one evaluation time"

    metric, table = resolve_metric_table(ev.engine, sel, ev.ctx)
    if table is None or not hasattr(table, "schema"):
        return None, f"table {metric} not found"
    is_dist = hasattr(table, "execute_tpu_plan")
    if not is_dist and not hasattr(table, "regions"):
        return None, f"{metric} is not a region-backed table"
    if is_dist and not tpu_exec._PARTIAL_PUSHDOWN[0]:
        return None, "SET dist_partial_agg = 0"
    if not is_dist:
        # same floor SQL's try_execute applies: small local tables are
        # faster (and float64-exact) on the existing row path
        est = tpu_exec._estimated_table_rows(table)
        if est is not None and est < tpu_exec.TPU_DISPATCH_MIN_ROWS:
            return None, (f"est_rows={est} < dispatch_floor="
                          f"{tpu_exec.TPU_DISPATCH_MIN_ROWS}")

    schema = table.schema
    if schema.timestamp_column is None:
        return None, f"{metric} has no time index"
    tag_names = schema.tag_names()
    tagset = set(tag_names)
    fields = _numeric_fields(schema, sel.matchers)
    if not fields:
        return EMPTY, ""
    if len(fields) > 1:
        return None, "multi-field table needs per-field series"

    preds = []
    for m in sel.matchers:
        if m.name == "__name__":
            if m.op != "=":
                return None, "non-equality __name__ matcher"
            continue
        if m.name == "__field__":
            continue
        if m.name not in tagset:
            # matching a non-existent label: ""-matching ops are
            # vacuously true, anything else statically matches nothing
            if _matches_empty(m):
                continue
            return EMPTY, ""
        if not schema.column_schema(m.name).dtype.is_string:
            return None, f"matcher on non-string tag {m.name}"
        col = Column(m.name)
        if m.op == "=":
            if m.value == "":
                # = "" keeps absent-or-empty labels; the stored-null
                # rendering only the row path implements
                return None, 'matcher = "" selects absent labels'
            preds.append(BinaryOp("=", col, Literal(m.value)))
        elif m.op == "!=":
            if m.value == "":
                preds.append(BinaryOp("!=", col, Literal("")))
            else:
                # a stored NULL renders as "" and "" != value, so keep
                # null rows explicitly (SQL != drops nulls)
                preds.append(BinaryOp("or", IsNull(col),
                                      BinaryOp("!=", col,
                                               Literal(m.value))))
        else:
            return None, f"regex matcher on {m.name}"

    ends = ev._grid(sel.offset_ms, None)
    t0 = int(ends[0])
    win = int(sel.range_ms) if func else int(ev.lookback)
    field = fields[0]
    aggs = [("__n", "count", field)]
    mspec: List[Tuple[str, str, str]] = []
    if func is None:
        aggs.append(("__v", "last", field))
        mspec.append(("__t", "max_ts", field))
    elif func in ("rate", "increase", "delta"):
        aggs += [("__first", "first", field), ("__last", "last", field)]
        mspec += [("__mnt", "min_ts", field), ("__mxt", "max_ts", field)]
        if func != "delta":
            mspec.append(("__corr", "reset_corr", field))
    elif func in ("last_over_time",):
        aggs.append(("__v", "last", field))
    elif func != "count_over_time":
        aggs.append(("__v", func[:-len("_over_time")], field))

    from ..query.tpu_exec import BucketGroup
    plan = ir.plan_from_specs(
        schema, aggs,
        group_tags=tag_names,          # per-series: full tag key
        bucket=BucketGroup(ev.step, t0 - ev.step + 1, "__promql_window"),
        time_lo=t0 - win + 1,          # _window_eval's matrix bound
        time_hi=int(ends[-1]) + 1,     # closed hi -> exclusive
        tag_predicates=preds,
        moment_specs=mspec)
    return LoweredSelect(table, plan, func, metric, field, tag_names,
                         t0, ends, win), ""


# ---------------------------------------------------------------------------
# executing a lowered shape and rebuilding the inner instant vector
# ---------------------------------------------------------------------------

def _key_str(v) -> str:
    from .engine import _label_str
    if isinstance(v, float) and np.isnan(v):
        return ""
    return _label_str(v)


def _series_keys(df, key_cols: List[str]):
    """(the sorted distinct label tuples of the frame's rows, each row's
    index into them), a row's tuple being its rendered key values
    (`_key_str`). The reference renders every row; here each key column
    is factorised, only its distinct values are rendered, and each
    distinct row of codes is rendered once: the same tuples in the same
    order, in time that does not grow with the rows' Python objects."""
    n = len(df)
    combo = np.zeros(n, dtype=np.int64)
    cols = []
    for c in key_cols:
        codes, uniques = df[c].factorize(use_na_sentinel=False)
        cols.append((codes, [_key_str(v) for v in uniques]))
        # compact after each column, so the combined code stays below n
        combo = np.unique(combo * len(uniques) + codes,
                          return_inverse=True)[1].astype(np.int64)
    _, first, inverse = np.unique(combo, return_index=True,
                                  return_inverse=True)
    keys = [tuple(names[codes[r]] for codes, names in cols) for r in first]
    uniq = sorted(set(keys))
    sid_of = {k: i for i, k in enumerate(uniq)}
    sid_of_combo = np.fromiter((sid_of[k] for k in keys), dtype=np.int64,
                               count=len(keys))
    return uniq, sid_of_combo[inverse]


def eval_lowered(ev, low: LoweredSelect):
    """Run the lowered plan and rebuild the inner instant vector —
    per-series values over the step grid with Prometheus staleness /
    extrapolation semantics replicated from ops/window.py."""
    from ..query import ir
    from .engine import _KEEP_NAME_RANGE_FUNCS, VectorVal

    df = ir.execute_agg_plan(low.table, low.plan, ev.engine.device)
    T = ev.nsteps
    if df is None or not len(df):
        return VectorVal([], np.zeros((0, T)), np.zeros((0, T), bool))
    from ..query.planner import _group_slot
    # buckets whose rows were all-null carry no sample: drop them so a
    # -inf max_ts sentinel never forward-fills
    df = df[df["__n"].to_numpy() > 0]
    if not len(df):
        return VectorVal([], np.zeros((0, T)), np.zeros((0, T), bool))

    uniq, sids = _series_keys(df, [_group_slot(t) for t in low.tag_names])
    S = len(uniq)
    step = ev.step
    bv = df[_group_slot("__promql_window")].to_numpy().astype(np.int64)
    # bucket lower edge -> window end -> step index (negative = the
    # instant path's lookback prefix, filled forward below)
    k = ((bv + step - 1) - low.t0) // step
    cnt = df["__n"].to_numpy().astype(np.float64)

    out_vals = np.full((S, T), np.nan)
    out_ok = np.zeros((S, T), dtype=bool)
    if low.func is None:
        last_v = df["__v"].to_numpy(dtype=np.float64)
        last_t = df["__t"].to_numpy(dtype=np.float64)
        off = -min(int(k.min()), 0)
        K = off + T
        pos = k + off
        inb = (pos >= 0) & (pos < K)
        val_g = np.full((S, K), np.nan)
        ts_g = np.full((S, K), -np.inf)
        val_g[sids[inb], pos[inb]] = last_v[inb]
        ts_g[sids[inb], pos[inb]] = last_t[inb]
        idx = np.where(ts_g > -np.inf, np.arange(K)[None, :], -1)
        idx = np.maximum.accumulate(idx, axis=1)
        has = idx >= 0
        gather = np.clip(idx, 0, None)
        vf = np.take_along_axis(val_g, gather, 1)
        tf = np.take_along_axis(ts_g, gather, 1)
        out_vals = vf[:, off:off + T]
        # same closed staleness bound instant_select applies on device
        out_ok = has[:, off:off + T] & \
            (tf[:, off:off + T] >= low.ends[None, :] - ev.lookback)
        out_vals = np.where(out_ok, out_vals, np.nan)
    else:
        inb = (k >= 0) & (k < T)
        with np.errstate(all="ignore"):
            if low.func in ("rate", "increase", "delta"):
                rowvals, rowok = _window_rate(df, low, k, cnt)
            elif low.func == "count_over_time":
                rowvals, rowok = cnt, cnt >= 1
            else:
                rowvals = df["__v"].to_numpy(dtype=np.float64)
                rowok = cnt >= 1
        out_vals[sids[inb], k[inb]] = rowvals[inb]
        out_ok[sids[inb], k[inb]] = rowok[inb]

    keep_name = low.func is None or low.func in _KEEP_NAME_RANGE_FUNCS
    labels: List[Dict[str, str]] = []
    for ukey in uniq:
        lbl: Dict[str, str] = {}
        if keep_name:
            lbl["__name__"] = low.metric
        for tn, tv in zip(low.tag_names, ukey):
            if tv != "":
                lbl[tn] = tv
        labels.append(lbl)
    return VectorVal(labels, out_vals, out_ok)


def _window_rate(df, low: LoweredSelect, k: np.ndarray, cnt: np.ndarray):
    """rate/increase/delta from per-window moments: the Prometheus
    extrapolation epilogue of ops/window.py `_extrapolate`, replicated
    on the frontend over merged first/last/min_ts/max_ts (+ the
    reset_corr moment for counters)."""
    first_v = df["__first"].to_numpy(dtype=np.float64)
    last_v = df["__last"].to_numpy(dtype=np.float64)
    first_t = df["__mnt"].to_numpy(dtype=np.float64)
    last_t = df["__mxt"].to_numpy(dtype=np.float64)
    rng = float(low.win)
    end_abs = (low.t0 + k * low.win).astype(np.float64)
    if low.func == "delta":
        raw = last_v - first_v
    else:
        raw = last_v - first_v + df["__corr"].to_numpy(dtype=np.float64)
    dur_to_start = first_t - (end_abs - rng)
    dur_to_end = end_abs - last_t
    sampled = last_t - first_t
    avg_dur = sampled / np.maximum(cnt - 1, 1)
    threshold = avg_dur * 1.1
    if low.func != "delta":
        # counters never extrapolate below zero
        dur_to_zero = np.where(
            (raw > 0) & (first_v >= 0),
            sampled * (first_v / np.where(raw == 0, 1.0, raw)), np.inf)
        dur_to_start = np.minimum(dur_to_start, dur_to_zero)
    ext_start = np.where(dur_to_start < threshold, dur_to_start,
                         avg_dur / 2)
    ext_end = np.where(dur_to_end < threshold, dur_to_end, avg_dur / 2)
    factor = (sampled + ext_start + ext_end) / \
        np.where(sampled == 0, 1.0, sampled)
    out = raw * factor
    if low.func == "rate":
        out = out / (rng / 1000.0)
    return out, (cnt >= 2) & (sampled > 0)


def try_lowered_inner(ev, e: Aggregate):
    """The engine's hook: the inner instant vector of this aggregate
    via the IR, or None to keep the row path. Degrades (never errors)
    when the executor rejects the plan — cost-based raw-pull, a
    version-skewed datanode, a sketch decode failure."""
    from .engine import VectorVal
    low, _reason = try_lower(ev, e)
    if low is EMPTY:
        T = ev.nsteps
        return VectorVal([], np.zeros((0, T)), np.zeros((0, T), bool))
    if low is None:
        return None
    try:
        return eval_lowered(ev, low)
    except UnsupportedError:
        return None


# ---------------------------------------------------------------------------
# EXPLAIN: the same dispatch stages SQL prints
# ---------------------------------------------------------------------------

def explain_lines(ev, expr) -> List[str]:
    """Plan/dispatch lines for TQL EXPLAIN — built by the same helpers
    SQL's EXPLAIN uses (dispatch_decision_for_pushdown /
    local_dispatch_decision), so the two surfaces cannot drift."""
    from ..query import tpu_exec

    aggs: List[Aggregate] = []
    sels: List[VectorSelector] = []

    def walk(node):
        if isinstance(node, Aggregate):
            aggs.append(node)
        if isinstance(node, VectorSelector):
            sels.append(node)
        for child in list(getattr(node, "args", []) or []):
            if isinstance(child, PromExpr):
                walk(child)
        for attr in ("expr", "lhs", "rhs"):
            child = getattr(node, attr, None)
            if isinstance(child, PromExpr):
                walk(child)

    walk(expr)
    lines: List[str] = []
    covered = set()
    for agg in aggs:
        low, reason = try_lower(ev, agg)
        if isinstance(low, LoweredSelect):
            covered.update(id(s) for s in sels
                           if s is agg.expr or
                           s in list(getattr(agg.expr, "args", []) or []))
            lines.append("TpuAggregateExec: " + low.plan.describe())
            if hasattr(low.table, "execute_tpu_plan"):
                lines.append("  Dispatch: " +
                             tpu_exec.dispatch_decision_for_pushdown(
                                 low.table, low.plan))
            else:
                lines.append("  Dispatch: " +
                             tpu_exec.local_dispatch_decision(
                                 low.table, plan=low.plan))
        elif low is EMPTY:
            lines.append("EmptyExec: matchers select no series")
        else:
            lines.append("  Dispatch: promql-row-path (" + reason + ")")
    for sel in sels:
        if id(sel) in covered:
            continue
        desc = _raw_scan_describe(ev, sel)
        if desc is not None:
            lines.append(desc)
    return lines


def _raw_scan_describe(ev, sel: VectorSelector) -> Optional[str]:
    """The RawScan leaf a row-path selector turns into."""
    from ..query import ir
    try:
        metric, table = resolve_metric_table(ev.engine, sel, ev.ctx)
    except UnsupportedError:
        return None
    if table is None or not hasattr(table, "schema"):
        return None
    schema = table.schema
    tc = schema.timestamp_column
    if tc is None:
        return None
    fields = _numeric_fields(schema, sel.matchers)
    ends = ev._grid(sel.offset_ms, sel.at_ms)
    win = int(sel.range_ms) if sel.range_ms else int(ev.lookback)
    lo = int(ends.min()) - win + 1
    hi = int(ends.max()) + 1
    tagset = set(schema.tag_names())
    n_push = sum(1 for m in sel.matchers
                 if m.op == "=" and m.name in tagset and m.value)
    scan = ir.RawScan(
        projection=list(schema.tag_names()) + [tc.name] + fields,
        time_range=(lo, hi), filters=[None] * n_push)
    return scan.describe()


# ---------------------------------------------------------------------------
# sanctioned data access: the engine's row-path selector
# ---------------------------------------------------------------------------

def select_series(engine, sel: VectorSelector, lo_ms: int, hi_ms: int,
                  ctx):
    """Fetch samples for a selector in the closed window [lo_ms, hi_ms]
    as a dense SeriesMatrix sorted by time within each series (the
    engine's `select`). In-process regions are read directly (device
    scan cache / streamed cold reads / SST-index sid pruning); a
    DistTable whose datanodes are remote has no in-process regions, so
    the same selector is served by an IR RawScan over the wire —
    pruned, filter-pushed, never silently empty."""
    from ..ops.window import SeriesMatrix
    from .engine import (
        _is_sorted, _label_str, _matcher_keep, _matches_empty, _Selection,
    )

    metric, table = resolve_metric_table(engine, sel, ctx)
    if table is None:
        return _Selection([], None)
    if not hasattr(table, "regions"):
        raise UnsupportedError(f"{metric} is not a region-backed table")

    schema = table.schema
    tag_names = schema.tag_names()
    tagset = set(tag_names)
    fields = _numeric_fields(schema, sel.matchers)
    if not fields:
        return _Selection([], None)
    multi_field = len(fields) > 1

    regions = table.regions
    if not regions and hasattr(table, "execute_tpu_plan"):
        return _wire_scan_selection(table, sel, metric, tag_names,
                                    fields, multi_field, lo_ms, hi_ms)

    key_to_gid: Dict[tuple, int] = {}
    glabels: List[Dict[str, str]] = []
    parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    eq_matchers = [m for m in sel.matchers
                   if m.op == "=" and m.name in tagset and m.value]
    # tag columns the matchers actually reference: the keep mask only
    # needs these decoded; everything else decodes later, and only for
    # the series that survive
    ref_idx = sorted({tag_names.index(m.name) for m in sel.matchers
                      if m.name in tagset})
    for region in regions.values():
        sid_set = matcher_sids(region, tag_names, eq_matchers)
        if sid_set is not None and len(sid_set) == 0:
            continue                 # no series of this region match
        scan = region_scan(region, fields, lo_ms, hi_ms, engine.device,
                           sid_set=sid_set)
        if scan is None or scan.num_rows == 0:
            continue
        sd = scan.series_dict
        S = sd.num_series
        if S == 0:
            continue
        ids = np.arange(S, dtype=np.int32)
        tag_strs: Dict[int, List[str]] = {
            i: [_label_str(v) for v in sd.decode_tag_column(ids, i)]
            for i in ref_idx}
        keep = np.ones(S, dtype=bool)
        for m in sel.matchers:
            if m.name in ("__name__", "__field__"):
                continue
            if m.name not in tagset:
                # matching a non-existent label: only ""-matching ops keep
                if not _matches_empty(m):
                    keep[:] = False
                continue
            keep &= _matcher_keep(tag_strs[tag_names.index(m.name)], m)
        if not keep.any():
            continue
        row_keep = keep[scan.series_ids] & (scan.ts >= lo_ms) & \
            (scan.ts <= hi_ms)
        if not row_keep.any():
            continue

        # decode the remaining tag columns only for surviving series
        survivors = np.unique(scan.series_ids[row_keep]).astype(np.int32)
        label_of: Dict[int, tuple] = {}
        cols = {i: tag_strs[i] if i in tag_strs else
                [_label_str(v) for v in
                 sd.decode_tag_column(survivors, i)]
                for i in range(len(tag_names))}
        for j, s in enumerate(survivors):
            label_of[int(s)] = tuple(
                cols[i][int(s)] if i in ref_idx else cols[i][j]
                for i in range(len(tag_names)))

        for fname in fields:
            vals, valid = scan.fields[fname]
            rk = row_keep if valid is None else (row_keep & valid)
            if not rk.any():
                continue
            sids = scan.series_ids[rk]
            ts = scan.ts[rk]
            v = vals[rk].astype(np.float64)
            # map region series → global series ids
            uniq = np.unique(sids)
            remap = np.full(S, -1, dtype=np.int32)
            for s in uniq:
                lbl_key = label_of[int(s)]
                gkey = lbl_key + ((fname,) if multi_field else ())
                gid = key_to_gid.get(gkey)
                if gid is None:
                    gid = len(glabels)
                    key_to_gid[gkey] = gid
                    lbl = {"__name__": metric}
                    for tn, tv in zip(tag_names, lbl_key):
                        if tv != "":
                            lbl[tn] = tv
                    if multi_field:
                        lbl["__field__"] = fname
                    glabels.append(lbl)
                remap[s] = gid
            parts.append((remap[sids], ts, v))

    if not parts:
        return _Selection([], None)
    gids = np.concatenate([p[0] for p in parts])
    ts = np.concatenate([p[1] for p in parts])
    vals = np.concatenate([p[2] for p in parts])
    # already sorted when a single region/field contributed in order
    if len(parts) > 1 or not _is_sorted(gids, ts):
        order = np.lexsort((ts, gids))
        gids, ts, vals = gids[order], ts[order], vals[order]
    sm = SeriesMatrix.build(gids, ts, vals, len(glabels))
    return _Selection(glabels, sm, int(ts.min()), int(ts.max()))


def _wire_scan_selection(table, sel: VectorSelector, metric: str,
                         tag_names: List[str], fields: List[str],
                         multi_field: bool, lo_ms: int, hi_ms: int):
    """Row-path selection over remote datanodes: an IR RawScan through
    DistTable.scan_batches — region pruning and equality-matcher wire
    pushdown apply; the remaining matchers filter the rows here."""
    from ..query import ir

    schema = table.schema
    tagset = set(tag_names)
    preds = []
    for m in sel.matchers:
        if m.op == "=" and m.name in tagset and m.value and \
                schema.column_schema(m.name).dtype.is_string:
            preds.append(BinaryOp("=", Column(m.name), Literal(m.value)))
    tc = schema.timestamp_column
    scan = ir.RawScan(
        projection=list(tag_names) + [tc.name] + list(fields),
        time_range=(lo_ms, hi_ms + 1), filters=preds)
    try:
        batches = ir.execute_raw_scan(table, scan)
    except NotImplementedError as e:
        raise UnsupportedError(
            f"PromQL over {metric}: its datanode client implements "
            "neither in-process regions nor the wire scan path; the "
            "lowered aggregate path (SET dist_partial_agg = 1) is the "
            "only route to these datanodes") from e
    return _label_wire_batches(batches, sel, metric, tag_names, tc.name,
                               fields, multi_field, lo_ms, hi_ms)


def _vector_arrays(rb, name: str):
    """(values, validity or None) of one column of a scanned batch."""
    col = rb.column(name)
    return col.data, col.validity


def _tag_runs(rb, tag_names: List[str]):
    """(start row of each run, each run's rendered label tuple): a run is
    a stretch of consecutive rows whose tag values are all equal. A
    region's scan returns its rows by series, so a batch holds about one
    run a series, and only one row of each run is rendered (a null reads
    as "", as `_label_str` renders it)."""
    from .engine import _label_str

    n = rb.num_rows
    change = np.zeros(max(n - 1, 0), dtype=bool)
    cols = []
    for t in tag_names:
        data, valid = _vector_arrays(rb, t)
        data = np.asarray(data, dtype=object)
        if valid is not None:
            data = data.copy()
            data[~valid] = None
        change |= data[1:] != data[:-1]
        cols.append(data)
    starts = np.concatenate([[0], np.nonzero(change)[0] + 1]).astype(
        np.int64)
    labels = [tuple(_label_str(col[r]) for col in cols) for r in starts]
    return starts, labels


def _label_wire_batches(batches, sel: VectorSelector, metric: str,
                        tag_names: List[str], ts_name: str,
                        fields: List[str], multi_field: bool, lo_ms: int,
                        hi_ms: int):
    """Label the wire scan's rows into a _Selection: the reference's
    per-row loop, run by run. Series ids go to label tuples (plus the
    field on a multi-field table) in the order the reference meets them
    (batch, then field, then row), and the rows keep that order before
    the stable (series, ts) sort, so the SeriesMatrix is the same."""
    from ..ops.window import SeriesMatrix
    from .engine import _matcher_keep, _matches_empty, _Selection

    tagset = set(tag_names)
    key_to_gid: Dict[tuple, int] = {}
    glabels: List[Dict[str, str]] = []
    gid_parts: List[np.ndarray] = []
    ts_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    for rb in batches:
        n = rb.num_rows
        if n == 0:
            continue
        starts, labels = _tag_runs(rb, tag_names)
        lengths = np.diff(np.append(starts, n))
        run_keep = np.ones(len(starts), dtype=bool)
        for m in sel.matchers:
            if m.name in ("__name__", "__field__"):
                continue
            if m.name not in tagset:
                if not _matches_empty(m):
                    run_keep[:] = False
                continue
            k = tag_names.index(m.name)
            run_keep &= _matcher_keep([lb[k] for lb in labels], m)
        ts = np.asarray(_vector_arrays(rb, ts_name)[0], dtype=np.int64)
        keep = np.repeat(run_keep, lengths) & (ts >= lo_ms) & (ts <= hi_ms)
        if not keep.any():
            continue
        run_of = np.repeat(np.arange(len(starts)), lengths)
        for fname in fields:
            data, valid = _vector_arrays(rb, fname)
            rows = np.nonzero(keep if valid is None else keep & valid)[0]
            if len(rows) == 0:
                continue
            # runs in row order: each label tuple is first met in the run
            # of its first kept row
            gid_of_run = np.full(len(starts), -1, dtype=np.int64)
            for r in np.unique(run_of[rows]):
                gkey = labels[r] + ((fname,) if multi_field else ())
                gid = key_to_gid.get(gkey)
                if gid is None:
                    gid = len(glabels)
                    key_to_gid[gkey] = gid
                    lbl = {"__name__": metric}
                    for tn, tv in zip(tag_names, labels[r]):
                        if tv != "":
                            lbl[tn] = tv
                    if multi_field:
                        lbl["__field__"] = fname
                    glabels.append(lbl)
                gid_of_run[r] = gid
            gid_parts.append(gid_of_run[run_of[rows]])
            ts_parts.append(ts[rows])
            val_parts.append(np.asarray(data[rows], dtype=np.float64))
    if not gid_parts:
        return _Selection([], None)
    gids = np.concatenate(gid_parts).astype(np.int32)
    tsa = np.concatenate(ts_parts)
    vals = np.concatenate(val_parts)
    order = np.lexsort((tsa, gids))            # stable: ties keep scan order
    gids, tsa, vals = gids[order], tsa[order], vals[order]
    sm = SeriesMatrix.build(gids, tsa, vals, len(glabels))
    return _Selection(glabels, sm, int(tsa.min()), int(tsa.max()))


def matcher_sids(region, tag_names, eq_matchers):
    """Sorted candidate sid superset for the selector's equality
    matchers in one region, or None when there is nothing selective
    to resolve — what lets the cold selector path prune whole SSTs
    through their index sidecars. Label values are matched on the
    same string rendering the keep-mask uses, so numeric tags
    resolve identically on both paths."""
    from ..storage.index import sst_index_enabled
    from .engine import _label_str
    if not eq_matchers or not sst_index_enabled():
        return None
    sd = getattr(region, "series_dict", None)
    if sd is None or not sd.tag_names:
        return None
    cand = None
    for m in eq_matchers:
        ti = tag_names.index(m.name)
        # O(1) dictionary hit for string tags (the common case);
        # the O(values) rendered-label scan only runs for tags whose
        # stored values are not strings
        vid = sd.tag_dicts[ti].get(m.value)
        if vid is not None:
            ids = [vid]
        else:
            ids = [i for i, v in
                   enumerate(sd.tag_dicts[ti].values())
                   if v is not None and not isinstance(v, str) and
                   _label_str(v) == m.value]
        sids = sd.sids_for_value_ids(ti, ids)
        cand = sids if cand is None else \
            np.intersect1d(cand, sids, assume_unique=True)
        if len(cand) == 0:
            break
    return cand


def region_scan(region, fields: List[str], lo_ms: int, hi_ms: int,
                device, sid_set=None):
    """Rows for one region: the scan cache's merged scan (the one the
    aggregate path keeps on `device`) for regions within the streaming
    bounds; a window-bounded cold read for regions past them, where the
    equality matchers' candidate series (`sid_set`) prune SSTs through
    their index sidecars. Both shapes expose
    series_ids/ts/fields/series_dict."""
    from ..common.telemetry import increment_counter
    from ..common.time import TimestampRange
    from ..query.tpu_exec import SCAN_CACHE, region_streams_cold

    if not region_streams_cold(region):
        increment_counter("promql_select_resident")
        return SCAN_CACHE.get(region, device)
    # cold path: merged host read of only the selector's window and
    # fields — proportional to the window, never enters the scan
    # cache, leaves no device residency behind
    increment_counter("promql_select_streamed")
    from ..common import exec_stats
    with exec_stats.stage("promql_cold_scan", region=region.name):
        # equality matchers ride the SST index: whole files whose
        # blooms exclude every candidate series never decode
        data = region.snapshot().read_merged(
            projection=list(fields),
            time_range=TimestampRange(lo_ms, hi_ms + 1),
            sid_set=sid_set)
    exec_stats.record("promql_cold_scan", rows=data.num_rows)
    return data
