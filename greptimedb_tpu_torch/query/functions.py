"""Built-in SQL functions.

Reference behavior: src/common/function — scalar math/numpy functions
(pow, rate, clip, interp — scalars/{math,numpy}/), timestamp helpers
(to_unixtime), and accumulator aggregates (argmax, argmin, mean, diff,
percentile, polyval, scipy_stats_norm_{cdf,pdf} —
scalars/aggregate/). Plus the DataFusion builtins the reference inherits
(abs/ceil/floor/round/sqrt/log/exp/trig, date_bin/date_trunc, now).

Scalar functions operate on numpy arrays (broadcast over scalars);
aggregates map a 1-D array → scalar. The TPU path uses ops/kernels.py for
the hot aggregates; these host implementations are the fallback and the
oracle.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..errors import InvalidArgumentsError


# ---------------------------------------------------------------------------
# interval parsing (SQL INTERVAL literals + PromQL-style durations)
# ---------------------------------------------------------------------------

_UNIT_MS = {
    "ms": 1, "millisecond": 1, "milliseconds": 1,
    "s": 1000, "sec": 1000, "second": 1000, "seconds": 1000,
    "m": 60_000, "min": 60_000, "minute": 60_000, "minutes": 60_000,
    "h": 3_600_000, "hour": 3_600_000, "hours": 3_600_000,
    "d": 86_400_000, "day": 86_400_000, "days": 86_400_000,
    "w": 604_800_000, "week": 604_800_000, "weeks": 604_800_000,
    "y": 31_536_000_000, "year": 31_536_000_000, "years": 31_536_000_000,
}


def parse_interval_ms(text: str) -> int:
    """'1 minute' / '5m' / '1h30m' / '90' (seconds per PromQL bare) → ms."""
    s = text.strip().lower()
    if not s:
        raise InvalidArgumentsError("empty interval")
    total = 0.0
    num = ""
    unit = ""
    items = []
    for ch in s:
        if ch.isdigit() or ch == "." or (ch == "-" and not num and not items):
            if unit:
                items.append((num, unit))
                num, unit = "", ""
            num += ch
        elif ch == " ":
            continue
        else:
            unit += ch
    items.append((num, unit))
    for num, unit in items:
        if not num:
            raise InvalidArgumentsError(f"bad interval: {text!r}")
        if not unit:
            total += float(num) * 1000  # bare number = seconds
            continue
        unit = unit.strip()
        if unit not in _UNIT_MS:
            raise InvalidArgumentsError(f"unknown interval unit {unit!r}")
        total += float(num) * _UNIT_MS[unit]
    return int(total)


# ---------------------------------------------------------------------------
# scalar functions
# ---------------------------------------------------------------------------

def _rate(values, timestamps=None):
    """Per-second rate between consecutive points (reference:
    scalars/math/rate.rs): diff(v) / diff(ts_seconds); first element null."""
    v = np.asarray(values, dtype=np.float64)
    out = np.full(v.shape, np.nan)
    if timestamps is None:
        out[1:] = np.diff(v)
        return out
    t = np.asarray(timestamps, dtype=np.float64) / 1000.0
    dt = np.diff(t)
    with np.errstate(divide="ignore", invalid="ignore"):
        out[1:] = np.diff(v) / np.where(dt == 0, np.nan, dt)
    return out


def _date_bin(interval_ms, ts, origin=0):
    t = np.asarray(ts, dtype=np.int64)
    step = int(interval_ms)
    return ((t - origin) // step) * step + origin


_TRUNC_MS = {"second": 1000, "minute": 60_000, "hour": 3_600_000,
             "day": 86_400_000, "week": 604_800_000}
# weeks are Monday-aligned (epoch 1970-01-01 is a Thursday; first epoch
# Monday is 1970-01-05), matching DataFusion date_trunc
_WEEK_ORIGIN_MS = 4 * 86_400_000


def _date_trunc(unit, ts):
    u = str(unit).lower()
    if u in _TRUNC_MS:
        step = _TRUNC_MS[u]
        t = np.asarray(ts, dtype=np.int64)
        if u == "week":
            return ((t - _WEEK_ORIGIN_MS) // step) * step + _WEEK_ORIGIN_MS
        return (t // step) * step
    # month/year need calendar math
    import pandas as pd
    s = pd.to_datetime(np.asarray(ts, dtype=np.int64), unit="ms", utc=True)
    if u == "month":
        out = s.to_period("M").to_timestamp(tz="UTC")
    elif u == "year":
        out = s.to_period("Y").to_timestamp(tz="UTC")
    else:
        raise InvalidArgumentsError(f"unsupported date_trunc unit {unit!r}")
    return (out.asi8 // 1_000_000).astype(np.int64)


def _to_unixtime(v):
    a = np.asarray(v)
    if a.dtype.kind in "iuf":
        return a.astype(np.int64)
    import pandas as pd
    return (pd.to_datetime(a, utc=True).asi8 // 1_000_000_000).astype(np.int64)


def _clip(v, lo, hi):
    return np.clip(np.asarray(v, dtype=np.float64), lo, hi)


def _interp(x, xp, fp):
    return np.interp(np.asarray(x, np.float64), np.asarray(xp, np.float64),
                     np.asarray(fp, np.float64))


SCALAR_FUNCTIONS: Dict[str, Callable] = {
    "abs": np.abs, "ceil": np.ceil, "floor": np.floor,
    "round": lambda v, d=0: np.round(np.asarray(v, np.float64), int(d)),
    "sqrt": np.sqrt, "exp": np.exp, "ln": np.log, "log": np.log10,
    "log2": np.log2, "log10": np.log10, "sin": np.sin, "cos": np.cos,
    "tan": np.tan, "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "atan2": np.arctan2, "signum": np.sign, "sign": np.sign,
    "power": np.power, "pow": np.power, "mod": np.mod,
    "clip": _clip, "interp": _interp, "rate": _rate,
    "to_unixtime": _to_unixtime,
    "date_bin": _date_bin, "date_trunc": _date_trunc,
    "length": lambda v: np.asarray([len(x) if x is not None else None
                                    for x in np.asarray(v, object)], object),
    "lower": lambda v: np.asarray([x.lower() if isinstance(x, str) else x
                                   for x in np.asarray(v, object)], object),
    "upper": lambda v: np.asarray([x.upper() if isinstance(x, str) else x
                                   for x in np.asarray(v, object)], object),
    "concat": lambda *vs: np.asarray(
        ["".join(str(x) for x in row) for row in zip(
            *[np.asarray(v, object) for v in vs])], object),
    "coalesce": lambda *vs: _coalesce(*vs),
}


def _coalesce(*vs):
    arrs = [np.asarray(v, object) for v in vs]
    out = arrs[0].copy()
    for a in arrs[1:]:
        sel = np.array([x is None or (isinstance(x, float) and math.isnan(x))
                        for x in out])
        out[sel] = a[sel]
    return out


# zero-arg / context functions, evaluated per query
def now_ms() -> int:
    return int(time.time() * 1000)


# ---------------------------------------------------------------------------
# aggregate functions (host/fallback implementations = the oracle)
# ---------------------------------------------------------------------------

def _valid(a):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a[~np.isnan(a)]
    if a.dtype == object:
        return np.asarray([x for x in a if x is not None])
    return a


def _agg_percentile(a, p):
    v = _valid(a)
    return float(np.percentile(v.astype(np.float64), p)) if v.size else None


def _agg_argmax(a):
    v = np.asarray(a, dtype=np.float64)
    if not v.size or np.all(np.isnan(v)):
        return None
    return int(np.nanargmax(v))


def _agg_argmin(a):
    v = np.asarray(a, dtype=np.float64)
    if not v.size or np.all(np.isnan(v)):
        return None
    return int(np.nanargmin(v))


def _agg_diff(a):
    """Aggregate diff: returns the list of consecutive differences
    (reference: scalars/aggregate/diff.rs outputs a vector)."""
    v = _valid(a).astype(np.float64)
    return np.diff(v).tolist() if v.size > 1 else []


def _agg_polyval(a, x):
    v = _valid(a).astype(np.float64)
    return float(np.polyval(v, x)) if v.size else None


def _norm_cdf(x):
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def _agg_norm_cdf(a, x=0.0):
    v = _valid(a).astype(np.float64)
    if not v.size:
        return None
    mu, sigma = float(v.mean()), float(v.std())
    if sigma == 0:
        return 0.5
    return _norm_cdf((x - mu) / sigma)


def _agg_norm_pdf(a, x=0.0):
    v = _valid(a).astype(np.float64)
    if not v.size:
        return None
    mu, sigma = float(v.mean()), float(v.std())
    if sigma == 0:
        return None
    z = (x - mu) / sigma
    return math.exp(-0.5 * z * z) / (sigma * math.sqrt(2 * math.pi))


def _agg_approx_distinct(a):
    """Sketch-backed distinct count — the standalone twin of the
    distributed HLL pushdown (query/sketches.py): exact below the
    bounded set size, HLL past it, so both engines answer within the
    same documented bound."""
    from .sketches import DistinctSketch
    v = _valid(a)
    if not v.size:
        return 0
    return DistinctSketch.from_values(v).result()


def _agg_approx_percentile(a, p=None):
    if p is None:
        raise InvalidArgumentsError(
            "approx_percentile(x, p) needs a percentile argument")
    p = float(p)
    if not (0.0 <= p <= 100.0):
        raise InvalidArgumentsError(
            f"approx_percentile: p must be in [0, 100], got {p}")
    from .sketches import TDigest
    v = _valid(a)
    if not v.size:
        return None
    return TDigest.from_values(v.astype(np.float64)).quantile(p)


def _agg_median(a):
    """t-digest median (documented approximation, same bound as
    approx_percentile(x, 50)); use percentile(x, 50) for the exact
    sort-based answer."""
    return _agg_approx_percentile(a, 50.0)


AGGREGATE_FUNCTIONS: Dict[str, Callable] = {
    "count": lambda a: int(_valid(a).size),
    "sum": lambda a: (lambda v: float(v.astype(np.float64).sum())
                      if v.size else None)(_valid(a)),
    "avg": lambda a: (lambda v: float(v.astype(np.float64).mean())
                      if v.size else None)(_valid(a)),
    "mean": lambda a: AGGREGATE_FUNCTIONS["avg"](a),
    "min": lambda a: (lambda v: v.min() if v.size else None)(_valid(a)),
    "max": lambda a: (lambda v: v.max() if v.size else None)(_valid(a)),
    # sample (ddof=1) to match DataFusion and the window path; <2 rows → NULL
    "stddev": lambda a: (lambda v: float(v.astype(np.float64).std(ddof=1))
                         if v.size >= 2 else None)(_valid(a)),
    "variance": lambda a: (lambda v: float(v.astype(np.float64).var(ddof=1))
                           if v.size >= 2 else None)(_valid(a)),
    "argmax": _agg_argmax,
    "argmin": _agg_argmin,
    "percentile": _agg_percentile,
    "approx_distinct": _agg_approx_distinct,
    "approx_percentile": _agg_approx_percentile,
    "median": _agg_median,
    "diff": _agg_diff,
    "polyval": _agg_polyval,
    "scipy_stats_norm_cdf": _agg_norm_cdf,
    "scipy_stats_norm_pdf": _agg_norm_pdf,
}

# aggregates the TPU sorted kernel executes natively (ops/kernels.py AGG_OPS)
TPU_AGGREGATES = {"count", "sum", "avg", "min", "max", "stddev", "variance",
                  "first", "last"}

# aggregates served by sketch partials in the partial-pushdown algebra
# (query/sketches.py): datanodes build per-group sketches, the frontend
# merges — plus count(DISTINCT x), which rides the same distinct sketch
SKETCH_AGGREGATES = {"approx_distinct", "approx_percentile", "median"}


# ---------------------------------------------------------------------------
# user-defined functions (coprocessors registered by the script engine;
# reference: src/script/src/python/engine.rs:44-80 registers each compiled
# coprocessor as a UDF in the query engine)
# ---------------------------------------------------------------------------

UDF_REGISTRY: Dict[str, Callable] = {}


def register_udf(name: str, fn: Callable) -> None:
    UDF_REGISTRY[name.lower()] = fn


def unregister_udf(name: str) -> None:
    UDF_REGISTRY.pop(name.lower(), None)
