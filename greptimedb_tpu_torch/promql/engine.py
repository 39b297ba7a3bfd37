"""PromQL evaluation engine on the port's window kernels (PyTorch / CUDA).

Reference behavior: src/promql/src/planner.rs compiles PromQL to DataFusion
plans with custom streaming nodes (SeriesNormalize / SeriesDivide / Instant-
and RangeManipulate) plus per-window scalar UDFs (functions/*.rs); the
servers shape results to Prometheus JSON (src/servers/src/prom.rs:150-400).

Design (the port of greptimedb_tpu/promql/engine.py): a selector's samples
arrive as a dense padded [series, time] matrix (`select`, the engine's one
data-access seam) and move once to the engine's device. Instant selection
and every range function are batched device passes over an aligned step
grid (ops/window.py); label grouping, vector matching, and JSON shaping
stay on the host where cardinality is small. Steps outside the data span
are masked on host so rebased int32 device timestamps never overflow.

The engine runs on `device` ("cuda" unless the caller asks for "cpu");
there is no fallback to the CPU. Data access lives in promql/lowering.py:
`select` reads the catalog table's regions (the scan cache, the
window-bounded cold read or the SST index), and aggregate-over-selector
shapes lower onto the SQL aggregate path (`_aggregate`). TQL EVAL /
EXPLAIN / ANALYZE (`execute_tql`) shape results as record batches.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..errors import (DeviceUnavailableError, GreptimeError,
                      UnsupportedError)
from ..ops.window import TS_PAD
from ..session import QueryContext
from .ast import (
    Aggregate, Binary, Call, Matcher, NumberLiteral, PromExpr, StringLiteral,
    SubqueryExpr, Unary, VectorSelector,
)
from .parser import PromqlParseError, parse_promql

DEFAULT_LOOKBACK_MS = 300_000           # Prometheus 5m lookback delta

_RANGE_FUNCS = {
    "rate", "increase", "delta", "idelta", "irate", "changes", "resets",
    "sum_over_time", "count_over_time", "avg_over_time", "min_over_time",
    "max_over_time", "stddev_over_time", "stdvar_over_time",
    "last_over_time", "first_over_time", "present_over_time",
    "quantile_over_time", "mad_over_time", "absent_over_time", "deriv",
    "predict_linear", "holt_winters",
}
# which drop the metric name from results (all except last_over_time)
_KEEP_NAME_RANGE_FUNCS = {"last_over_time"}


def _fetch_pair(v, ok):
    """Bring a (values, ok) kernel result to the host."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    if isinstance(ok, torch.Tensor):
        ok = ok.cpu().numpy()
    return _from_device_f32(v), np.asarray(ok)


def _from_device_f32(v) -> np.ndarray:
    """Bring device results to host float64, honestly.

    The device path computes in float32 (as the reference does); a raw cast to
    float64 fabricates noise digits (f32 of 2.0/60 → 1.9999998807907104…).
    A single f32 carries ~7.2 significant decimal digits and the window/rate
    chains accumulate a few ulps, so quantize to 6 — emitted samples then
    read as the values they actually are at device precision (rate of a
    steady counter prints 2.0, not 1.9999998807907104)."""
    a = np.asarray(v)
    if a.dtype != np.float32:
        return np.asarray(a, dtype=np.float64)
    out = np.asarray(a, dtype=np.float64)
    finite = np.isfinite(out) & (out != 0.0)
    mag = np.floor(np.log10(np.abs(out, where=finite, out=np.ones_like(out))))
    dec = 5.0 - mag
    scale = np.power(10.0, dec, where=finite, out=np.ones_like(out))
    good = finite & np.isfinite(scale) & (scale != 0)
    return np.where(good, np.round(out * scale) / scale, out)

_SIMPLE_FUNCS = {
    "abs": np.abs, "ceil": np.ceil, "floor": np.floor, "exp": np.exp,
    "ln": np.log, "log2": np.log2, "log10": np.log10, "sqrt": np.sqrt,
    "sgn": np.sign, "acos": np.arccos, "asin": np.arcsin,
    "atan": np.arctan, "cos": np.cos, "sin": np.sin, "tan": np.tan,
    "cosh": np.cosh, "sinh": np.sinh, "tanh": np.tanh,
    "acosh": np.arccosh, "asinh": np.arcsinh, "atanh": np.arctanh,
    "rad": np.radians, "deg": np.degrees,
}

_CMP_NP = {"==": np.equal, "!=": np.not_equal, "<": np.less,
           "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}
_SET_OPS = {"and", "or", "unless"}
_ARITH_NP = {
    "+": np.add, "-": np.subtract, "*": np.multiply,
    # PromQL % is Go math.Mod (truncated toward zero) = C fmod
    "/": np.divide, "%": np.fmod, "^": np.power, "atan2": np.arctan2,
}


# ---------------------------------------------------------------------------
# value types
# ---------------------------------------------------------------------------

@dataclass
class ScalarVal:
    v: np.ndarray                       # [T] float64


@dataclass
class StringVal:
    v: str


@dataclass
class VectorVal:
    """Instant vector evaluated on the step grid."""
    labels: List[Dict[str, str]]        # per series
    values: np.ndarray                  # [S, T] float64
    ok: np.ndarray                      # [S, T] bool

    @property
    def num_series(self) -> int:
        return len(self.labels)

    def drop_name(self) -> "VectorVal":
        labels = [{k: v for k, v in l.items() if k != "__name__"}
                  for l in self.labels]
        return VectorVal(labels, self.values, self.ok)


@dataclass
class MatrixVal:
    """Raw range samples (top-level matrix selector in an instant query)."""
    labels: List[Dict[str, str]]
    sample_ts: List[np.ndarray]         # per series, ms
    sample_vals: List[np.ndarray]


# ---------------------------------------------------------------------------
# series selection
# ---------------------------------------------------------------------------

@dataclass
class _Selection:
    labels: List[Dict[str, str]]
    matrix: object                      # ops.window.SeriesMatrix or None
    data_min: int = 0
    data_max: int = -1

    @property
    def empty(self) -> bool:
        return self.matrix is None


def _compile_anchored(pattern: str) -> "re.Pattern":
    """Fully-anchored user regex; invalid patterns are a query error
    (Prometheus returns 400 bad_data), not a server crash."""
    try:
        return re.compile(f"^(?:{pattern})$")
    except re.error as e:
        raise PromqlParseError(f"invalid regex {pattern!r}: {e}") from e


def _matcher_keep(values: List[str], m: Matcher) -> np.ndarray:
    if m.op == "=":
        return np.asarray([v == m.value for v in values])
    if m.op == "!=":
        return np.asarray([v != m.value for v in values])
    rx = _compile_anchored(m.value)
    hit = np.asarray([bool(rx.match(v)) for v in values])
    return hit if m.op == "=~" else ~hit


class PromqlEngine:
    """Evaluates PromQL over catalog tables (metric name = table name,
    tags = labels, field column(s) = values)."""

    def __init__(self, catalog, device="cuda"):
        self.catalog = catalog
        self.device = torch.device(device)

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    def query_range(self, query: str, start_ms: int, end_ms: int,
                    step_ms: int, ctx: Optional[QueryContext] = None,
                    lookback_ms: int = DEFAULT_LOOKBACK_MS):
        ctx = ctx or QueryContext()
        expr = parse_promql(query)
        ev = _Eval(self, ctx, start_ms, end_ms, step_ms, lookback_ms)
        return ev.eval(expr), ev.steps

    def query_to_prom_json(self, query: str, start_ms: int, end_ms: int,
                           step_ms: int, ctx: Optional[QueryContext] = None,
                           *, instant: bool = False,
                           lookback_ms: int = DEFAULT_LOOKBACK_MS) -> dict:
        ctx = ctx or QueryContext()
        expr = parse_promql(query)
        if instant:
            end_ms = start_ms
            step_ms = max(step_ms, 1)
        ev = _Eval(self, ctx, start_ms, end_ms, step_ms, lookback_ms,
                   raw_matrix_ok=instant)
        val = ev.eval(expr)
        return _to_prom_json(val, ev.steps, instant=instant)

    def execute_tql(self, stmt, ctx: QueryContext):
        """TQL EVAL / EXPLAIN / ANALYZE (a `sql.ast.Tql`) as an Output."""
        from ..common.time import parse_prom_duration, parse_prom_time
        if stmt.kind not in ("eval", "evaluate", "explain", "analyze"):
            raise UnsupportedError(f"TQL {stmt.kind.upper()} not supported")
        start_ms = parse_prom_time(stmt.start)
        end_ms = parse_prom_time(stmt.end)
        step_ms = parse_prom_duration(stmt.step)
        lookback = parse_prom_duration(stmt.lookback) if stmt.lookback \
            else DEFAULT_LOOKBACK_MS
        expr = parse_promql(stmt.query)
        ev = _Eval(self, ctx, start_ms, end_ms, step_ms, lookback)
        if stmt.kind == "explain":
            return self._explain_output(expr, None, ev=ev)
        if stmt.kind == "analyze":
            import time as _time

            from ..common import exec_stats
            stats = exec_stats.ExecStats()
            t0 = _time.perf_counter()
            with exec_stats.collect(stats):
                val = ev.eval(expr)
            elapsed_ms = (_time.perf_counter() - t0) * 1e3
            nseries = len(getattr(val, "labels", [])) or 1
            return self._explain_output(expr, {
                "elapsed_ms": round(elapsed_ms, 2),
                "series": nseries, "steps": len(ev.steps),
                "stats": stats}, ev=ev)
        val = ev.eval(expr)
        return _to_record_batches(val, ev.steps)

    def explain_lines(self, query: str, start_ms: int, end_ms: int,
                      step_ms: int, ctx: Optional[QueryContext] = None,
                      lookback_ms: int = DEFAULT_LOOKBACK_MS) -> List[str]:
        """The plan/dispatch lines TQL EXPLAIN renders, as a list (the
        Prometheus HTTP API's ?explain=1 surface)."""
        ctx = ctx or QueryContext()
        expr = parse_promql(query)
        ev = _Eval(self, ctx, start_ms, end_ms, step_ms, lookback_ms)
        return self._plan_lines(expr, ev)

    def _plan_lines(self, expr, ev: Optional["_Eval"]) -> List[str]:
        """The EXPLAIN text: the evaluation plan tree, one node per
        line, then the same dispatch stages SQL's EXPLAIN prints for
        the statement's lowered (or row-path) scan."""
        lines: List[str] = []

        def walk(e, depth):
            pad = "  " * depth
            name = type(e).__name__
            if isinstance(e, VectorSelector):
                sel = ", ".join(f"{m.name}{m.op}{m.value!r}"
                                for m in e.matchers)
                rng = f"[{e.range_ms}ms]" if getattr(e, "range_ms", None) \
                    else ""
                lines.append(f"{pad}PromSeriesScan: {e.metric}{rng}"
                             f" {{{sel}}}")
            elif isinstance(e, Call):
                lines.append(f"{pad}PromCall: {e.func}")
            elif isinstance(e, Aggregate):
                mod = ""
                if e.by:
                    mod = f" by ({', '.join(e.by)})"
                elif e.without:
                    mod = f" without ({', '.join(e.without)})"
                lines.append(f"{pad}PromAggregate: {e.op}{mod}")
            elif isinstance(e, Binary):
                lines.append(f"{pad}PromBinary: {e.op}")
            elif isinstance(e, NumberLiteral):
                lines.append(f"{pad}Literal: {e.value}")
            else:
                lines.append(f"{pad}{name}")
            for child in list(getattr(e, "args", []) or []):
                if isinstance(child, PromExpr):
                    walk(child, depth + 1)
            for attr in ("expr", "lhs", "rhs"):
                child = getattr(e, attr, None)
                if isinstance(child, PromExpr):
                    walk(child, depth + 1)

        walk(expr, 0)
        if ev is not None:
            from . import lowering
            lines.extend(lowering.explain_lines(ev, expr))
        return lines

    def _explain_output(self, expr, analyze: Optional[dict],
                        ev: Optional["_Eval"] = None):
        """TQL EXPLAIN / ANALYZE (reference: tql_parser.rs parses all
        three verbs; EXPLAIN shows the plan the planner built)."""
        from ..datatypes import data_type as dt
        from ..datatypes.record_batch import RecordBatch
        from ..datatypes.schema import ColumnSchema, Schema
        from ..query.output import Output
        lines = self._plan_lines(expr, ev)
        rows = {"plan_type": ["logical_plan"], "plan": ["\n".join(lines)]}
        if analyze is not None:
            analyzed = (f"elapsed: {analyze['elapsed_ms']}ms, series: "
                        f"{analyze['series']}, steps: {analyze['steps']}")
            stats = analyze.get("stats")
            if stats is not None:
                # the executed dispatch + per-stage breakdown, same
                # collector SQL's EXPLAIN ANALYZE renders
                tbl = stats.rows_table()
                for st, rows_, ms, detail in zip(
                        tbl.get("stage", []), tbl.get("rows", []),
                        tbl.get("elapsed_ms", []),
                        tbl.get("detail", [])):
                    analyzed += (f"\n{st}: rows={rows_}, "
                                 f"elapsed: {ms}ms"
                                 f"{', ' + detail if detail else ''}")
            rows["plan_type"].append("analyze")
            rows["plan"].append(analyzed)
        schema = Schema([ColumnSchema("plan_type", dt.STRING),
                         ColumnSchema("plan", dt.STRING)])
        return Output.record_batches(
            [RecordBatch.from_pydict(schema, rows)], schema)

    # ------------------------------------------------------------------
    # data access
    # ------------------------------------------------------------------
    def select(self, sel: VectorSelector, lo_ms: int, hi_ms: int,
               ctx: QueryContext) -> _Selection:
        """Fetch samples for a selector in the closed window [lo_ms, hi_ms]
        as a dense SeriesMatrix sorted by time within each series.

        All data access lives in promql/lowering.py — the one module
        under promql/ that touches regions and the scan cache."""
        from . import lowering
        return lowering.select_series(self, sel, lo_ms, hi_ms, ctx)


def _label_str(v) -> str:
    if v is None:
        return ""
    return str(v)


def _matches_empty(m: Matcher) -> bool:
    if m.op == "=":
        return m.value == ""
    if m.op == "!=":
        return m.value != ""
    rx = _compile_anchored(m.value)
    hit = bool(rx.match(""))
    return hit if m.op == "=~" else not hit


def _is_sorted(gids: np.ndarray, ts: np.ndarray) -> bool:
    if len(gids) < 2:
        return True
    g1, g0 = gids[1:], gids[:-1]
    return bool(np.all((g1 > g0) | ((g1 == g0) & (ts[1:] >= ts[:-1]))))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

class _Eval:
    def __init__(self, engine: PromqlEngine, ctx: QueryContext,
                 start_ms: int, end_ms: int, step_ms: int, lookback_ms: int,
                 raw_matrix_ok: bool = False):
        if step_ms <= 0:
            raise PromqlParseError("step must be positive")
        if end_ms < start_ms:
            raise PromqlParseError("end is before start")
        self.engine = engine
        self.ctx = ctx
        self.start = int(start_ms)
        self.end = int(end_ms)
        self.step = int(step_ms)
        self.lookback = int(lookback_ms)
        self.steps = np.arange(self.start, self.end + 1, self.step,
                               dtype=np.int64)
        self.nsteps = len(self.steps)
        self.raw_matrix_ok = raw_matrix_ok
        # per-evaluation device caches: matrices stay resident in HBM and
        # window bounds are shared across range functions over the same
        # selector (rate + avg_over_time recompute identical bounds
        # otherwise — the dominant cost at 10k-series scale)
        self._dev_cache: Dict[int, tuple] = {}
        self._bounds_cache: Dict[tuple, tuple] = {}

    # -- top-level dispatch --
    def eval(self, e: PromExpr):
        if isinstance(e, NumberLiteral):
            return ScalarVal(np.full(self.nsteps, e.value, dtype=np.float64))
        if isinstance(e, StringLiteral):
            return StringVal(e.value)
        if isinstance(e, VectorSelector):
            if e.range_ms:
                if self.raw_matrix_ok and self.nsteps == 1:
                    return self._raw_matrix(e)
                raise PromqlParseError(
                    "matrix selector must be wrapped in a range function")
            return self._instant(e)
        if isinstance(e, Unary):
            v = self.eval(e.expr)
            if isinstance(v, ScalarVal):
                return ScalarVal(-v.v)
            if isinstance(v, VectorVal):
                return VectorVal(v.drop_name().labels, -v.values, v.ok)
            raise UnsupportedError("unary minus on non-numeric")
        if isinstance(e, Call):
            return self._call(e)
        if isinstance(e, Aggregate):
            return self._aggregate(e)
        if isinstance(e, Binary):
            return self._binary(e)
        if isinstance(e, SubqueryExpr):
            raise UnsupportedError("subqueries are not supported yet")
        raise UnsupportedError(f"cannot evaluate {type(e).__name__}")

    # -- selector evaluation --
    def _grid(self, offset_ms: int, at_ms) -> np.ndarray:
        """Step ends adjusted for offset/@ (evaluation times)."""
        if at_ms is None:
            ends = self.steps - offset_ms
        elif at_ms == "start":
            ends = np.full(self.nsteps, self.start - offset_ms, np.int64)
        elif at_ms == "end":
            ends = np.full(self.nsteps, self.end - offset_ms, np.int64)
        else:
            ends = np.full(self.nsteps, int(at_ms) - offset_ms, np.int64)
        return ends

    def _window_eval(self, sel: VectorSelector, win_ms: int, kernel):
        """Shared instant/range evaluation: fetch, clip the step grid to the
        data span, run the device kernel on the in-range steps, mask the
        rest. kernel(matrix, t0_rel, nsteps) -> (vals [S,T'], ok [S,T'])."""
        ends = self._grid(sel.offset_ms, sel.at_ms)
        fixed = sel.at_ms is not None
        lo = int(ends.min()) - win_ms + 1
        hi = int(ends.max())
        selection = self.engine.select(sel, lo, hi, self.ctx)
        S = len(selection.labels)
        out_vals = np.full((S, self.nsteps), np.nan, dtype=np.float64)
        out_ok = np.zeros((S, self.nsteps), dtype=bool)
        if selection.empty or S == 0:
            return VectorVal(selection.labels, out_vals, out_ok)
        dmin, dmax = selection.data_min, selection.data_max

        if fixed:
            t = int(ends[0])
            if t < dmin or t - win_ms > dmax:
                return VectorVal(selection.labels, out_vals, out_ok)
            v, ok = kernel(selection.matrix, np.int64(t), 1)
            v, ok = _fetch_pair(v, ok)
            v = v[:, :1]
            ok = ok[:, :1]
            out_vals[:] = np.repeat(v, self.nsteps, axis=1)
            out_ok[:] = np.repeat(ok, self.nsteps, axis=1)
            return VectorVal(selection.labels, out_vals, out_ok)

        t0 = int(ends[0])
        # in-range steps: end >= dmin and end - win <= dmax
        j0 = max(0, -(-(dmin - t0) // self.step))
        j1 = min(self.nsteps - 1, (dmax + win_ms - t0) // self.step)
        if j0 > j1:
            return VectorVal(selection.labels, out_vals, out_ok)
        n_eval = j1 - j0 + 1
        n_pad = 1 << (n_eval - 1).bit_length() if n_eval > 1 else 1
        v, ok = kernel(selection.matrix, np.int64(t0 + j0 * self.step),
                       n_pad)
        v, ok = _fetch_pair(v, ok)
        v = v[:, :n_eval]
        ok = ok[:, :n_eval]
        out_vals[:, j0:j1 + 1] = v
        out_ok[:, j0:j1 + 1] = ok
        return VectorVal(selection.labels, out_vals, out_ok)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        dev = self.engine.device
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "PromqlEngine runs on 'cuda' but CUDA is not available; "
                "construct it with device='cpu' to run on the CPU")
        return torch.as_tensor(a, device=dev)

    def _device_args(self, matrix, t0: np.int64, nsteps: int):
        """Rebase (ts2d, t0) for int32 device transfer; arrays move to the
        engine's device once per matrix and are reused across range
        functions."""
        _, ts2d, val2d, lengths, base, _ = self._dev_entry(matrix)
        return ts2d, val2d, lengths, np.int64(t0) - base

    def _dev_entry(self, matrix):
        """Cache entry (matrix, ts2d, val2d, lengths, base, host ts): the
        device arrays and the rebased timestamps still on the host."""
        # the cache entry holds `matrix` itself: id() keys are only unique
        # while the object is alive, so pin it for the evaluation
        ent = self._dev_cache.get(id(matrix))
        if ent is None:
            ts_host, val2d, lengths, base = matrix.device_arrays()
            if val2d.dtype == np.float64:       # float32 on the device
                val2d = val2d.astype(np.float32)
            ts2d = ts_host
            if ts2d.dtype != np.int64:   # int64 stays host for the safety net
                ts2d = self._to_device(ts2d)
            val2d = self._to_device(val2d)
            lengths = self._to_device(lengths)
            ent = (matrix, ts2d, val2d, lengths, base, ts_host)
            self._dev_cache[id(matrix)] = ent
        return ent

    def _rel_seconds(self, matrix) -> torch.Tensor:
        """Sample times in seconds from the rebase base (pads 0), built
        from the host timestamps — never read back from the device."""
        ts_host = self._dev_entry(matrix)[5]
        rel = np.asarray(ts_host, dtype=np.float64) / 1000.0
        rel = np.where(np.asarray(matrix.ts) == TS_PAD, 0.0, rel)
        return self._to_device(rel.astype(np.float32))

    def _cached_bounds(self, matrix, ts2d, t0r, win: int, nsteps: int):
        """Window bounds shared across range functions on one selector."""
        from ..ops.window import compute_window_bounds
        key = (id(matrix), int(t0r), int(win), nsteps)
        ent = self._bounds_cache.get(key)
        if ent is None:
            b = compute_window_bounds(ts2d, t0r, step=self.step,
                                      range_ms=int(win), nsteps=nsteps)
            ent = (matrix, b)   # pin matrix: id() keys need it alive
            self._bounds_cache[key] = ent
        return ent[1]

    #: widest extended grid (nsteps + range/step) the aligned fast path may
    #: build — beyond this (wide-range instant queries like rate(x[1d]) at
    #: one step) the O(nsteps) two-pass bounds form is both faster and
    #: bounded in memory
    _ALIGNED_MAX_EXT = 4096

    def _aligned_ok(self, win: int, nsteps: int) -> bool:
        return (win % self.step == 0 and win >= 0 and
                win // self.step + nsteps <= self._ALIGNED_MAX_EXT)

    def _aligned_eval(self, matrix, ts2d, val2d, lengths, t0r, win: int,
                      nsteps: int):
        """AlignedWindowEval shared across range functions on one selector
        (step-aligned windows): one bounds pass + one stacked gather serve
        rate, avg_over_time, and the rest of the cumsum family."""
        from ..ops.window import AlignedWindowEval
        key = ("awe", id(matrix), int(t0r), int(win), nsteps)
        ent = self._bounds_cache.get(key)
        if ent is None:
            awe = AlignedWindowEval(ts2d, val2d, lengths, t0r, self.step,
                                    int(win), nsteps)
            ent = (matrix, awe)   # pin matrix: id() keys need it alive
            self._bounds_cache[key] = ent
        return ent[1]

    def _bounds_for(self, matrix, ts2d, val2d, lengths, t0r, win: int,
                    nsteps: int):
        """Window bounds for any kernel path (None when ts stays host
        int64 for the safety net)."""
        if isinstance(ts2d, np.ndarray):
            return None
        if self._aligned_ok(win, nsteps):
            return self._aligned_eval(matrix, ts2d, val2d, lengths, t0r,
                                      win, nsteps).bounds()
        return self._cached_bounds(matrix, ts2d, t0r, win, nsteps)

    def _instant(self, sel: VectorSelector) -> VectorVal:
        from ..ops.window import instant_select

        def kernel(matrix, t0, nsteps):
            ts2d, val2d, lengths, t0r = self._device_args(matrix, t0, nsteps)
            return instant_select(ts2d, val2d, t0r, self.step, self.lookback,
                                  nsteps=nsteps)

        return self._window_eval(sel, self.lookback, kernel)

    def _range_func(self, func: str, sel: VectorSelector,
                    param: float = 0.0, param2: float = 0.0) -> VectorVal:
        from ..ops.window import (
            CUMSUM_OPS, GATHER_OPS, range_aggregate_cumsum,
            range_aggregate_gather)

        win = sel.range_ms
        if not win:
            raise PromqlParseError(f"{func} expects a range vector")
        op = func
        if func == "irate":
            op = "irate_num"            # reset-corrected idelta / sample gap
        if func == "absent_over_time":
            op = "count_over_time"

        def kernel(matrix, t0, nsteps):
            ts2d, val2d, lengths, t0r = self._device_args(matrix, t0, nsteps)
            if op in CUMSUM_OPS and not isinstance(ts2d, np.ndarray) \
                    and self._aligned_ok(win, nsteps):
                awe = self._aligned_eval(matrix, ts2d, val2d, lengths, t0r,
                                         win, nsteps)
                return awe.eval(op)
            bounds = self._bounds_for(matrix, ts2d, val2d, lengths, t0r,
                                      win, nsteps)
            if op in CUMSUM_OPS:
                return range_aggregate_cumsum(
                    ts2d, val2d, lengths, t0r, self.step, win,
                    op=op, nsteps=nsteps, param=param, bounds=bounds)
            if op in GATHER_OPS:
                maxw = int(matrix.max_len)
                return range_aggregate_gather(
                    ts2d, val2d, t0r, self.step, win, op=op, nsteps=nsteps,
                    maxw=max(maxw, 2), param=param, param2=param2,
                    bounds=bounds)
            raise UnsupportedError(f"range function {func} not implemented")

        out = self._window_eval(sel, win, kernel)
        if func == "irate":
            # irate = last difference / gap seconds; approximate gap from
            # idelta pair — recompute via two instant gathers host-side
            gap = self._range_func_gap(sel)
            with np.errstate(divide="ignore", invalid="ignore"):
                out = VectorVal(out.labels, out.values / gap.values,
                                out.ok & gap.ok & (gap.values > 0))
        if func not in _KEEP_NAME_RANGE_FUNCS:
            out = out.drop_name()
        if func == "absent_over_time":
            return self._absent_like(out, sel)
        return out

    def _range_func_gap(self, sel: VectorSelector) -> VectorVal:
        """Seconds between the last two samples in each window (for irate)."""
        from ..ops.window import range_aggregate_cumsum
        win = sel.range_ms

        def kernel(matrix, t0, nsteps):
            ts2d, val2d, lengths, t0r = self._device_args(matrix, t0, nsteps)
            bounds = self._bounds_for(matrix, ts2d, val2d, lengths, t0r,
                                      win, nsteps)
            # idelta over *rebased* sample times: absolute epoch seconds
            # (~1.7e9) as float32 device values would cancel to 0 between
            # adjacent samples; a gap of relative seconds is exact
            return range_aggregate_cumsum(
                ts2d, self._rel_seconds(matrix), lengths, t0r, self.step,
                win, op="idelta", nsteps=nsteps, bounds=bounds)

        return self._window_eval(sel, win, kernel)

    def _raw_matrix(self, sel: VectorSelector) -> MatrixVal:
        ends = self._grid(sel.offset_ms, sel.at_ms)
        t = int(ends[0])
        selection = self.engine.select(sel, t - sel.range_ms + 1, t,
                                       self.ctx)
        if selection.empty:
            return MatrixVal([], [], [])
        sm = selection.matrix
        labels, s_ts, s_vals = [], [], []
        for s in range(sm.num_series):
            L = int(sm.lengths[s])
            if L == 0:
                continue
            labels.append(selection.labels[s])
            s_ts.append(np.asarray(sm.ts[s, :L]))
            s_vals.append(np.asarray(sm.values[s, :L]))
        return MatrixVal(labels, s_ts, s_vals)

    # -- functions --
    def _call(self, e: Call):
        f = e.func
        if f in _RANGE_FUNCS:
            return self._eval_range_call(e)
        if f == "time":
            return ScalarVal(self.steps.astype(np.float64) / 1000.0)
        if f == "pi":
            return ScalarVal(np.full(self.nsteps, math.pi))
        if f == "scalar":
            v = self._vec_arg(e, 0)
            if v.num_series == 1:
                out = np.where(v.ok[0], v.values[0], np.nan)
            else:
                out = np.full(self.nsteps, np.nan)
            return ScalarVal(out.astype(np.float64))
        if f == "vector":
            s = self.eval(e.args[0])
            if not isinstance(s, ScalarVal):
                raise PromqlParseError("vector() expects a scalar")
            return VectorVal([{}], s.v[None, :].copy(),
                             np.ones((1, self.nsteps), dtype=bool))
        if f == "absent":
            arg = e.args[0] if e.args else None
            sel = arg if isinstance(arg, VectorSelector) else None
            return self._absent_like(self._vec_arg(e, 0), sel)
        if f == "timestamp":
            v = self._vec_arg(e, 0)
            arg = e.args[0]
            if isinstance(arg, VectorSelector) and not arg.range_ms:
                ts_v = self._instant_ts(arg)
                return VectorVal(v.drop_name().labels, ts_v.values, v.ok)
            # fall back: the step time where the sample is present
            tsec = np.broadcast_to(self.steps.astype(np.float64) / 1000.0,
                                   v.values.shape)
            return VectorVal(v.drop_name().labels, tsec.copy(), v.ok)
        if f in _SIMPLE_FUNCS:
            v = self._vec_arg(e, 0)
            with np.errstate(all="ignore"):
                out = _SIMPLE_FUNCS[f](v.values)
            return VectorVal(v.drop_name().labels, out, v.ok)
        if f == "round":
            v = self._vec_arg(e, 0)
            to = 1.0
            if len(e.args) > 1:
                s = self.eval(e.args[1])
                if not isinstance(s, ScalarVal):
                    raise PromqlParseError("round() nearest must be scalar")
                to = float(s.v[0])
            if to <= 0:
                raise PromqlParseError("round() nearest must be positive")
            out = np.floor(v.values / to + 0.5) * to
            return VectorVal(v.drop_name().labels, out, v.ok)
        if f in ("clamp", "clamp_min", "clamp_max"):
            v = self._vec_arg(e, 0)
            out = v.values.copy()
            with np.errstate(invalid="ignore"):
                if f == "clamp":
                    lo, hi = (self._scalar_arg(e, i) for i in (1, 2))
                    out = np.minimum(np.maximum(out, lo[None, :]),
                                     hi[None, :])
                elif f == "clamp_min":
                    out = np.maximum(out, self._scalar_arg(e, 1)[None, :])
                else:
                    out = np.minimum(out, self._scalar_arg(e, 1)[None, :])
            return VectorVal(v.drop_name().labels, out, v.ok)
        if f in ("sort", "sort_desc"):
            v = self._vec_arg(e, 0)
            lastcol = v.values[:, -1] if v.values.size else \
                np.zeros(v.num_series)
            key = np.where(v.ok[:, -1] if v.ok.size else False,
                           lastcol, -np.inf if f == "sort" else np.inf)
            order = np.argsort(-key if f == "sort_desc" else key,
                               kind="stable")
            return VectorVal([v.labels[i] for i in order],
                             v.values[order], v.ok[order])
        if f == "histogram_quantile":
            phi = self._scalar_arg(e, 0)
            v = self._vec_arg(e, 1)
            return self._histogram_quantile(phi, v)
        if f == "label_replace":
            return self._label_replace(e)
        if f == "label_join":
            return self._label_join(e)
        if f in ("minute", "hour", "day_of_week", "day_of_month",
                 "day_of_year", "days_in_month", "month", "year"):
            return self._time_component(e, f)
        raise UnsupportedError(f"function {f} is not supported")

    def _eval_range_call(self, e: Call):
        f = e.func
        param = param2 = 0.0
        if f == "quantile_over_time":
            if len(e.args) != 2:
                raise PromqlParseError(f"{f} expects (q, range-vector)")
            param = float(self._scalar_arg(e, 0)[0])
            sel = e.args[1]
        elif f == "predict_linear":
            if len(e.args) != 2:
                raise PromqlParseError(f"{f} expects (range-vector, t)")
            sel = e.args[0]
            param = float(self._scalar_arg(e, 1)[0])
        elif f == "holt_winters":
            if len(e.args) != 3:
                raise PromqlParseError(f"{f} expects (range-vector, sf, tf)")
            sel = e.args[0]
            param = float(self._scalar_arg(e, 1)[0])
            param2 = float(self._scalar_arg(e, 2)[0])
        else:
            if len(e.args) != 1:
                raise PromqlParseError(f"{f} expects one range vector")
            sel = e.args[0]
        if not isinstance(sel, VectorSelector) or not sel.range_ms:
            raise PromqlParseError(f"{f} expects a matrix selector argument")
        return self._range_func(f, sel, param, param2)

    def _vec_arg(self, e: Call, i: int) -> VectorVal:
        if i >= len(e.args):
            raise PromqlParseError(f"{e.func} missing argument {i}")
        v = self.eval(e.args[i])
        if not isinstance(v, VectorVal):
            raise PromqlParseError(
                f"{e.func} argument {i} must be an instant vector")
        return v

    def _scalar_arg(self, e: Call, i: int) -> np.ndarray:
        v = self.eval(e.args[i])
        if not isinstance(v, ScalarVal):
            raise PromqlParseError(f"{e.func} argument {i} must be scalar")
        return v.v

    def _absent_like(self, v: VectorVal,
                     sel: Optional[VectorSelector] = None) -> VectorVal:
        present = v.ok.any(axis=0) if v.num_series else \
            np.zeros(self.nsteps, dtype=bool)
        vals = np.ones((1, self.nsteps), dtype=np.float64)
        # prometheus derives the result labels from the selector's equality
        # matchers (absent(up{job="api"}) -> {job="api"})
        labels: Dict[str, str] = {}
        if sel is not None:
            for m in sel.matchers:
                if m.op == "=" and m.name != "__name__":
                    labels[m.name] = m.value
        return VectorVal([labels], vals, ~present[None, :])

    def _instant_ts(self, sel: VectorSelector) -> VectorVal:
        """Instant select over the sample timestamps (seconds)."""
        from ..ops.window import instant_select
        base_holder = {}

        def kernel(matrix, t0, nsteps):
            ts2d, val2d, lengths, t0r = self._device_args(matrix, t0, nsteps)
            # relative seconds on device (absolute epoch seconds lose up to
            # ~128s as float32); the base is added back on host below
            base_holder["base"] = self._dev_entry(matrix)[4]
            return instant_select(ts2d, self._rel_seconds(matrix), t0r,
                                  self.step, self.lookback, nsteps=nsteps)

        out = self._window_eval(sel, self.lookback, kernel)
        base_sec = base_holder.get("base", 0) / 1000.0
        return VectorVal(out.labels, out.values + base_sec, out.ok)

    def _time_component(self, e: Call, f: str) -> VectorVal:
        if e.args:
            v = self._vec_arg(e, 0)
            secs = v.values
            labels, ok = v.drop_name().labels, v.ok
        else:
            secs = (self.steps.astype(np.float64) / 1000.0)[None, :]
            labels = [{}]
            ok = np.ones_like(secs, dtype=bool)
        out = _calendar_component(secs * 1000, f)
        if f == "day_of_week":
            out = (out + 1) % 7        # prometheus: Sunday = 0
        return VectorVal(labels, out, ok)

    def _histogram_quantile(self, phi: np.ndarray, v: VectorVal) -> VectorVal:
        groups: Dict[tuple, List[Tuple[float, int]]] = {}
        glabels: Dict[tuple, Dict[str, str]] = {}
        for i, lbl in enumerate(v.labels):
            le = lbl.get("le")
            if le is None:
                continue
            try:
                bound = float("inf") if le in ("+Inf", "Inf", "inf") \
                    else float(le)
            except ValueError:
                continue
            key = tuple(sorted((k, val) for k, val in lbl.items()
                               if k not in ("le", "__name__")))
            groups.setdefault(key, []).append((bound, i))
            glabels[key] = {k: val for k, val in lbl.items()
                            if k not in ("le", "__name__")}
        labels, rows, oks = [], [], []
        T = self.nsteps
        for key, buckets in groups.items():
            buckets.sort()
            bounds = np.asarray([b for b, _ in buckets])
            idx = [i for _, i in buckets]
            counts = v.values[idx]                     # [B, T] cumulative
            bok = v.ok[idx]
            counts = np.where(bok, counts, 0.0)
            counts = np.maximum.accumulate(counts, axis=0)  # enforce monotone
            total = counts[-1]
            # prometheus requires >= 2 buckets with an +Inf upper bound
            if len(bounds) < 2 or not math.isinf(bounds[-1]):
                ok = np.zeros(T, dtype=bool)
            else:
                ok = bok.any(axis=0) & (total > 0)
            rank = np.clip(phi, 0.0, 1.0) * total
            b = np.argmax(counts >= rank[None, :], axis=0)  # first >= rank
            b = np.clip(b, 0, len(bounds) - 1)
            hi = bounds[b]
            lo = np.where(b > 0, bounds[np.maximum(b - 1, 0)], 0.0)
            c_hi = np.take_along_axis(counts, b[None, :], axis=0)[0]
            c_lo = np.where(b > 0,
                            np.take_along_axis(counts,
                                               np.maximum(b - 1, 0)[None, :],
                                               axis=0)[0], 0.0)
            # highest bucket (+Inf): return lower bound of it
            inf_b = np.isinf(hi)
            with np.errstate(divide="ignore", invalid="ignore"):
                frac = np.where(c_hi > c_lo, (rank - c_lo) / (c_hi - c_lo),
                                0.0)
                res = lo + (hi - lo) * frac
            res = np.where(inf_b, lo, res)
            res = np.where(np.isnan(phi) | (phi < 0), -np.inf,
                           np.where(phi > 1, np.inf, res))
            labels.append(glabels[key])
            rows.append(res)
            oks.append(ok)
        if not labels:
            return VectorVal([], np.zeros((0, T)), np.zeros((0, T), bool))
        return VectorVal(labels, np.asarray(rows), np.asarray(oks))

    def _label_replace(self, e: Call) -> VectorVal:
        if len(e.args) != 5:
            raise PromqlParseError(
                "label_replace expects (v, dst, repl, src, regex)")
        v = self._vec_arg(e, 0)
        dst, repl, src, regex = (self._str_arg(e, i) for i in (1, 2, 3, 4))
        rx = _compile_anchored(regex)
        labels = []
        for lbl in v.labels:
            cur = dict(lbl)
            m = rx.match(cur.get(src, ""))
            if m:
                val = m.expand(_go_template_to_py(repl))
                if val:
                    cur[dst] = val
                else:
                    cur.pop(dst, None)
            labels.append(cur)
        return VectorVal(labels, v.values, v.ok)

    def _label_join(self, e: Call) -> VectorVal:
        if len(e.args) < 3:
            raise PromqlParseError(
                "label_join expects (v, dst, sep, src...)")
        v = self._vec_arg(e, 0)
        dst = self._str_arg(e, 1)
        sep = self._str_arg(e, 2)
        srcs = [self._str_arg(e, i) for i in range(3, len(e.args))]
        labels = []
        for lbl in v.labels:
            cur = dict(lbl)
            val = sep.join(cur.get(s, "") for s in srcs)
            if val:
                cur[dst] = val
            else:
                cur.pop(dst, None)
            labels.append(cur)
        return VectorVal(labels, v.values, v.ok)

    def _str_arg(self, e: Call, i: int) -> str:
        v = self.eval(e.args[i])
        if not isinstance(v, StringVal):
            raise PromqlParseError(f"{e.func} argument {i} must be a string")
        return v.v

    # -- aggregation --
    def _aggregate(self, e: Aggregate):
        # lowered fast path: aggregate-over-selector shapes rebuild the
        # inner instant vector from the plan IR's moment fold (per-group
        # frames instead of raw samples); anything the lowering declines
        # — or that the executor degrades — evaluates on the row path
        from . import lowering
        v = lowering.try_lowered_inner(self, e)
        if v is None:
            v = self.eval(e.expr)
        if not isinstance(v, VectorVal):
            raise PromqlParseError(f"{e.op} expects an instant vector")
        param = None
        if e.param is not None:
            p = self.eval(e.param)
            if isinstance(p, ScalarVal):
                param = p.v
            elif isinstance(p, StringVal):
                param = p.v
        T = self.nsteps

        # group key per series
        def key_of(lbl: Dict[str, str]) -> tuple:
            if e.by is not None:
                return tuple((k, lbl.get(k, "")) for k in sorted(e.by))
            if e.without is None:
                return ()              # no modifier: one group, no labels
            drop = set(e.without) | {"__name__"}
            return tuple(sorted((k, val) for k, val in lbl.items()
                                if k not in drop))

        if e.op in ("topk", "bottomk"):
            if param is None:
                raise PromqlParseError(f"{e.op} needs a scalar parameter")
            k = int(param[0])
            groups: Dict[tuple, List[int]] = {}
            for i, lbl in enumerate(v.labels):
                groups.setdefault(key_of(lbl), []).append(i)
            ok = np.zeros_like(v.ok)
            sign = -1.0 if e.op == "topk" else 1.0
            for idxs in groups.values():
                vals = v.values[idxs]
                gok = v.ok[idxs]
                rank_vals = np.where(gok, sign * vals, np.inf)
                order = np.argsort(rank_vals, axis=0, kind="stable")
                ranks = np.empty_like(order)
                np.put_along_axis(ranks, order,
                                  np.arange(len(idxs))[:, None] *
                                  np.ones_like(order), axis=0)
                keep = (ranks < k) & gok
                for r, i in enumerate(idxs):
                    ok[i] = keep[r]
            return VectorVal(v.labels, v.values, ok)

        if e.op == "count_values":
            if not isinstance(param, str):
                raise PromqlParseError("count_values needs a label name")
            out: Dict[tuple, Tuple[Dict[str, str], np.ndarray]] = {}
            for i, lbl in enumerate(v.labels):
                base_key = key_of(lbl)
                for t in range(T):
                    if not v.ok[i, t]:
                        continue
                    vs = _fmt_float(v.values[i, t])
                    key = base_key + ((param, vs),)
                    if key not in out:
                        glbl = dict(base_key)
                        glbl[param] = vs
                        out[key] = (glbl, np.zeros(T))
                    out[key][1][t] += 1
            if not out:
                return VectorVal([], np.zeros((0, T)),
                                 np.zeros((0, T), bool))
            labels = [lv[0] for lv in out.values()]
            vals = np.asarray([lv[1] for lv in out.values()])
            return VectorVal(labels, vals, vals > 0)

        groups: Dict[tuple, List[int]] = {}
        for i, lbl in enumerate(v.labels):
            groups.setdefault(key_of(lbl), []).append(i)
        labels, rows, oks = [], [], []
        for key, idxs in groups.items():
            vals = v.values[idxs]
            gok = v.ok[idxs]
            cnt = gok.sum(axis=0)
            any_ok = cnt > 0
            z = np.where(gok, vals, 0.0)
            with np.errstate(all="ignore"):
                if e.op == "sum":
                    r = z.sum(axis=0)
                elif e.op == "count":
                    r = cnt.astype(np.float64)
                elif e.op == "group":
                    r = np.ones(T)
                elif e.op == "avg":
                    r = z.sum(axis=0) / np.maximum(cnt, 1)
                elif e.op == "min":
                    r = np.where(gok, vals, np.inf).min(axis=0)
                elif e.op == "max":
                    r = np.where(gok, vals, -np.inf).max(axis=0)
                elif e.op in ("stddev", "stdvar"):
                    n = np.maximum(cnt, 1)
                    mean = z.sum(axis=0) / n
                    var = (np.where(gok, (vals - mean[None, :]) ** 2, 0.0)
                           .sum(axis=0)) / n
                    r = var if e.op == "stdvar" else np.sqrt(var)
                elif e.op == "quantile":
                    if param is None:
                        raise PromqlParseError("quantile needs a parameter")
                    r = _masked_quantile_np(vals, gok, float(param[0]))
                else:
                    raise UnsupportedError(f"aggregate {e.op}")
            labels.append({k: v for k, v in key if v != ""})
            rows.append(r)
            oks.append(any_ok)
        if not labels:
            return VectorVal([], np.zeros((0, T)), np.zeros((0, T), bool))
        return VectorVal(labels, np.asarray(rows, dtype=np.float64),
                         np.asarray(oks))

    # -- binary operators --
    def _binary(self, e: Binary):
        lhs = self.eval(e.lhs)
        rhs = self.eval(e.rhs)
        op = e.op

        if isinstance(lhs, ScalarVal) and isinstance(rhs, ScalarVal):
            if op in _SET_OPS:
                raise PromqlParseError(f"{op} not defined between scalars")
            with np.errstate(all="ignore"):
                if op in _CMP_NP:
                    if not e.return_bool:
                        raise PromqlParseError(
                            "comparisons between scalars must use bool")
                    return ScalarVal(
                        _CMP_NP[op](lhs.v, rhs.v).astype(np.float64))
                return ScalarVal(_ARITH_NP[op](lhs.v, rhs.v))

        if op in _SET_OPS:
            if not (isinstance(lhs, VectorVal) and isinstance(rhs, VectorVal)):
                raise PromqlParseError(f"{op} requires vector operands")
            return self._set_op(op, lhs, rhs, e.matching)

        if isinstance(lhs, VectorVal) and isinstance(rhs, ScalarVal):
            return self._vec_scalar(op, lhs, rhs.v, e.return_bool,
                                    scalar_on_left=False)
        if isinstance(lhs, ScalarVal) and isinstance(rhs, VectorVal):
            return self._vec_scalar(op, rhs, lhs.v, e.return_bool,
                                    scalar_on_left=True)
        if isinstance(lhs, VectorVal) and isinstance(rhs, VectorVal):
            return self._vec_vec(e, lhs, rhs)
        raise PromqlParseError(f"invalid operands for {op}")

    def _vec_scalar(self, op, v: VectorVal, s: np.ndarray, ret_bool: bool,
                    scalar_on_left: bool) -> VectorVal:
        with np.errstate(all="ignore"):
            if op in _CMP_NP:
                a, b = (s[None, :], v.values) if scalar_on_left else \
                    (v.values, s[None, :])
                cond = _CMP_NP[op](a, b)
                if ret_bool:
                    return VectorVal(v.drop_name().labels,
                                     cond.astype(np.float64), v.ok.copy())
                return VectorVal(v.labels, v.values, v.ok & cond)
            a, b = (s[None, :], v.values) if scalar_on_left else \
                (v.values, s[None, :])
            out = _ARITH_NP[op](a, b)
        return VectorVal(v.drop_name().labels, out, v.ok.copy())

    def _sig(self, lbl: Dict[str, str], matching) -> tuple:
        if matching is not None and matching.on is not None:
            return tuple((k, lbl.get(k, "")) for k in sorted(matching.on))
        drop = {"__name__"}
        if matching is not None and matching.ignoring:
            drop |= set(matching.ignoring)
        return tuple(sorted((k, v) for k, v in lbl.items() if k not in drop))

    def _set_op(self, op, lhs: VectorVal, rhs: VectorVal,
                matching) -> VectorVal:
        T = self.nsteps
        rsigs: Dict[tuple, np.ndarray] = {}
        for i, lbl in enumerate(rhs.labels):
            s = self._sig(lbl, matching)
            rsigs[s] = rsigs.get(s, np.zeros(T, dtype=bool)) | rhs.ok[i]
        if op == "and":
            ok = np.zeros_like(lhs.ok)
            for i, lbl in enumerate(lhs.labels):
                have = rsigs.get(self._sig(lbl, matching))
                if have is not None:
                    ok[i] = lhs.ok[i] & have
            return VectorVal(lhs.labels, lhs.values, ok)
        if op == "unless":
            ok = lhs.ok.copy()
            for i, lbl in enumerate(lhs.labels):
                have = rsigs.get(self._sig(lbl, matching))
                if have is not None:
                    ok[i] = lhs.ok[i] & ~have
            return VectorVal(lhs.labels, lhs.values, ok)
        # or
        lsigs: Dict[tuple, np.ndarray] = {}
        for i, lbl in enumerate(lhs.labels):
            s = self._sig(lbl, matching)
            lsigs[s] = lsigs.get(s, np.zeros(T, dtype=bool)) | lhs.ok[i]
        labels = list(lhs.labels)
        values = [lhs.values]
        oks = [lhs.ok]
        radd_ok = np.zeros_like(rhs.ok)
        for i, lbl in enumerate(rhs.labels):
            have = lsigs.get(self._sig(lbl, matching))
            radd_ok[i] = rhs.ok[i] & ~(have if have is not None
                                       else np.zeros(T, dtype=bool))
        keep = radd_ok.any(axis=1)
        for i in np.nonzero(keep)[0]:
            labels.append(rhs.labels[i])
        values.append(rhs.values[keep])
        oks.append(radd_ok[keep])
        return VectorVal(labels, np.concatenate(values, axis=0),
                         np.concatenate(oks, axis=0))

    def _vec_vec(self, e: Binary, lhs: VectorVal, rhs: VectorVal
                 ) -> VectorVal:
        """Vector/vector binary with label matching. The "many" side drives
        iteration (lhs unless group_right); the "one" side must have unique
        signatures. The operator is always applied in (lhs, rhs) order."""
        op = e.op
        m = e.matching
        group_left = bool(m and m.group_left)
        group_right = bool(m and m.group_right)
        many, one = (rhs, lhs) if group_right else (lhs, rhs)

        one_side: Dict[tuple, int] = {}
        for i, lbl in enumerate(one.labels):
            s = self._sig(lbl, m)
            if s in one_side:
                side = "left" if group_right else "right"
                raise GreptimeError(
                    "many-to-many matching not allowed: duplicate series on "
                    f"the {side} side")
            one_side[s] = i

        labels, vals, oks = [], [], []
        seen_result: Dict[tuple, int] = {}
        for i, lbl in enumerate(many.labels):
            j = one_side.get(self._sig(lbl, m))
            if j is None:
                continue
            if group_right:
                lv, rv = one.values[j], many.values[i]
                lok, rok = one.ok[j], many.ok[i]
            else:
                lv, rv = many.values[i], one.values[j]
                lok, rok = many.ok[i], one.ok[j]
            filter_keep = many.values[i]   # filter comparisons keep the
            with np.errstate(all="ignore"):  # many-side sample values
                if op in _CMP_NP:
                    cond = _CMP_NP[op](lv, rv)
                    if e.return_bool:
                        out = cond.astype(np.float64)
                        ok = lok & rok
                        rl = {k: v for k, v in lbl.items()
                              if k != "__name__"}
                    else:
                        out = filter_keep
                        ok = lok & rok & cond
                        rl = dict(lbl)
                else:
                    out = _ARITH_NP[op](lv, rv)
                    ok = lok & rok
                    rl = {k: v for k, v in lbl.items() if k != "__name__"}
            if m and m.include:
                for k in m.include:
                    inc = one.labels[j].get(k)
                    if inc is not None:
                        rl[k] = inc
                    else:
                        rl.pop(k, None)
            if not (group_left or group_right):
                # one-to-one: result labels are the match signature
                if not (op in _CMP_NP and not e.return_bool):
                    rl = dict(self._sig(lbl, m))
                rkey = tuple(sorted(rl.items()))
                if rkey in seen_result:
                    raise GreptimeError(
                        "multiple matches for labels: many-to-one matching "
                        "must use group_left/group_right")
                seen_result[rkey] = i
            labels.append(rl)
            vals.append(out)
            oks.append(ok)
        T = self.nsteps
        if not labels:
            return VectorVal([], np.zeros((0, T)), np.zeros((0, T), bool))
        return VectorVal(labels, np.asarray(vals), np.asarray(oks))


def _calendar_component(ms: np.ndarray, f: str) -> np.ndarray:
    """A UTC calendar field of epoch-millisecond values, as float64 (NaN
    where the input is not finite). day_of_week counts Monday as 0."""
    out = np.full(np.shape(ms), np.nan)
    fin = np.isfinite(ms)
    t = np.floor(ms[fin]).astype(np.int64).astype("datetime64[ms]")
    day = t.astype("datetime64[D]")
    month = t.astype("datetime64[M]")
    year = t.astype("datetime64[Y]")
    ms_of_day = (t - day).astype(np.int64)
    if f == "minute":
        r = ms_of_day // 60_000 % 60
    elif f == "hour":
        r = ms_of_day // 3_600_000
    elif f == "day_of_week":
        r = (day.astype(np.int64) + 3) % 7      # 1970-01-01 was a Thursday
    elif f == "day_of_month":
        r = (day - month.astype("datetime64[D]")).astype(np.int64) + 1
    elif f == "day_of_year":
        r = (day - year.astype("datetime64[D]")).astype(np.int64) + 1
    elif f == "days_in_month":
        r = ((month + 1).astype("datetime64[D]") -
             month.astype("datetime64[D]")).astype(np.int64)
    elif f == "month":
        r = month.astype(np.int64) % 12 + 1
    else:                                       # year
        r = year.astype(np.int64) + 1970
    out[fin] = r
    return out


def _masked_quantile_np(vals: np.ndarray, ok: np.ndarray, q: float
                        ) -> np.ndarray:
    big = np.where(ok, vals, np.inf)
    sv = np.sort(big, axis=0)
    n = ok.sum(axis=0)
    if math.isnan(q) or q < 0:
        return np.full(vals.shape[1], -np.inf)
    if q > 1:
        return np.full(vals.shape[1], np.inf)
    pos = q * np.maximum(n - 1, 0)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, np.maximum(n - 1, 0))
    frac = pos - lo
    idx = np.arange(vals.shape[1])
    lo_v = sv[np.clip(lo, 0, sv.shape[0] - 1), idx]
    hi_v = sv[np.clip(hi, 0, sv.shape[0] - 1), idx]
    return lo_v + (hi_v - lo_v) * frac


def _go_template_to_py(repl: str) -> str:
    """Convert Go regexp replacement ($1, ${name}) to Python (\\1, \\g<name>)."""
    out = re.sub(r"\$\{(\w+)\}", r"\\g<\1>", repl)
    out = re.sub(r"\$(\d+)", r"\\\1", out)
    out = re.sub(r"\$(\w+)", r"\\g<\1>", out)
    return out


# ---------------------------------------------------------------------------
# result shaping
# ---------------------------------------------------------------------------

def _fmt_float(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e17:
        return str(int(v))
    return repr(float(v))


def _to_prom_json(val, steps: np.ndarray, *, instant: bool) -> dict:
    tsec = steps.astype(np.float64) / 1000.0
    if isinstance(val, StringVal):
        return {"resultType": "string",
                "result": [tsec[-1], val.v]}
    if isinstance(val, ScalarVal):
        if instant:
            return {"resultType": "scalar",
                    "result": [tsec[-1], _fmt_float(float(val.v[-1]))]}
        return {"resultType": "matrix", "result": [{
            "metric": {},
            "values": [[t, _fmt_float(float(v))]
                       for t, v in zip(tsec, val.v)],
        }]}
    if isinstance(val, MatrixVal):
        return {"resultType": "matrix", "result": [{
            "metric": lbl,
            "values": [[ts / 1000.0, _fmt_float(float(v))]
                       for ts, v in zip(sts, svs)],
        } for lbl, sts, svs in zip(val.labels, val.sample_ts,
                                   val.sample_vals)]}
    assert isinstance(val, VectorVal)
    if instant:
        result = []
        for i, lbl in enumerate(val.labels):
            if not val.ok[i, -1]:
                continue
            result.append({"metric": lbl,
                           "value": [tsec[-1],
                                     _fmt_float(float(val.values[i, -1]))]})
        return {"resultType": "vector", "result": result}
    result = []
    for i, lbl in enumerate(val.labels):
        oksteps = np.nonzero(val.ok[i])[0]
        if len(oksteps) == 0:
            continue
        result.append({
            "metric": lbl,
            "values": [[tsec[j], _fmt_float(float(val.values[i, j]))]
                       for j in oksteps],
        })
    return {"resultType": "matrix", "result": result}


def _to_record_batches(val, steps: np.ndarray):
    """Shape an evaluation result as record batches for TQL EVAL (the
    reference returns tags + ts + value columns)."""
    from ..datatypes import data_type as dt
    from ..datatypes.record_batch import RecordBatch
    from ..datatypes.schema import ColumnSchema, Schema, SemanticType
    from ..query.output import Output

    def ts_value_schema(label_keys):
        return Schema(
            [ColumnSchema(k, dt.STRING) for k in label_keys] +
            [ColumnSchema("ts", dt.TIMESTAMP_MILLISECOND, nullable=False,
                          semantic_type=SemanticType.TIMESTAMP),
             ColumnSchema("value", dt.FLOAT64)])

    if isinstance(val, ScalarVal):
        rb = RecordBatch.from_pydict(ts_value_schema([]), {
            "ts": steps.tolist(), "value": val.v.tolist()})
        return Output.record_batches([rb])
    if isinstance(val, MatrixVal):
        label_keys = sorted({k for lbl in val.labels for k in lbl})
        cols: Dict[str, list] = {k: [] for k in label_keys}
        ts_out, v_out = [], []
        for lbl, sts, svs in zip(val.labels, val.sample_ts, val.sample_vals):
            for t, v in zip(sts, svs):
                for k in label_keys:
                    cols[k].append(lbl.get(k, ""))
                ts_out.append(int(t))
                v_out.append(float(v))
    elif isinstance(val, VectorVal):
        label_keys = sorted({k for lbl in val.labels for k in lbl})
        cols = {k: [] for k in label_keys}
        ts_out, v_out = [], []
        for i, lbl in enumerate(val.labels):
            for j in np.nonzero(val.ok[i])[0]:
                for k in label_keys:
                    cols[k].append(lbl.get(k, ""))
                ts_out.append(int(steps[j]))
                v_out.append(float(val.values[i, j]))
    else:
        raise UnsupportedError("TQL result must be a vector or scalar")
    data = dict(cols)
    data["ts"] = ts_out
    data["value"] = v_out
    return Output.record_batches([RecordBatch.from_pydict(
        ts_value_schema(label_keys), data)])
