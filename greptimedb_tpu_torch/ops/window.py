"""PromQL range-vector evaluation as batched window reductions, in PyTorch.

Reference behavior: src/promql — `RangeManipulate` materializes per-step
window views (`RangeArray`, a DictionaryArray trick) and evaluates range
functions row-by-row per series (aggr_over_time.rs, extrapolate_rate.rs).

Design (the port of greptimedb_tpu/ops/window.py): series are laid out as
a dense padded matrix [S, L] sorted by time within each row. For an
aligned step grid t_j = start + j*step, the window (t_j - range, t_j] of
every series is located by bucketing every sample onto the step grid
and counting buckets per step, both in one pass of the hand-written
window-bounds kernel (ops/pallas_window.py:counts_leq_grid), and:

- sum/count/avg/stddev/rate/increase/delta/changes/resets/last/first/idelta
  evaluate O(1) per window from per-series prefix sums (cumsum path);
- min/max/quantile/deriv/predict_linear gather bounded windows (maxw) and
  reduce with masking (gather path).

Counter resets are handled with a per-series cumulative correction array so
`increase` is a pure difference of adjusted prefix values — no per-window
scan. Extrapolation follows Prometheus `extrapolatedRate` semantics
(reference: src/promql/src/functions/extrapolate_rate.rs:53-200).

Every function runs as torch ops on the device of its tensor inputs. The
dtypes are the JAX package's with x64 off: timestamps are int32 offsets
from a base (padding is int32 max), values float32. Host numpy inputs are
narrowed the same way; host int64 timestamps are rebased by
`_rebase_i64_host`, which raises when the span does not fit int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .pallas_window import counts_leq_grid, step_buckets  # noqa: F401

TS_PAD = np.iinfo(np.int64).max

#: device numpy-only inputs go to when no tensor argument names one
DEFAULT_DEVICE = "cuda"

CUMSUM_OPS = {
    "sum_over_time", "count_over_time", "avg_over_time", "stddev_over_time",
    "stdvar_over_time", "last_over_time", "first_over_time", "present_over_time",
    "rate", "increase", "delta", "idelta", "irate_num", "changes", "resets",
}
GATHER_OPS = {"min_over_time", "max_over_time", "quantile_over_time",
              "deriv", "predict_linear", "mad_over_time", "holt_winters"}
RANGE_OPS = CUMSUM_OPS | GATHER_OPS


class SeriesMatrix:
    """Dense padded [num_series, max_len] layout of a set of time series
    (host numpy arrays; the engine moves them to its device)."""

    __slots__ = ("ts", "values", "lengths", "num_series", "max_len")

    def __init__(self, ts: np.ndarray, values: np.ndarray, lengths: np.ndarray):
        self.ts = ts
        self.values = values
        self.lengths = lengths
        self.num_series, self.max_len = ts.shape

    @staticmethod
    def build(series_ids: np.ndarray, ts: np.ndarray, values: np.ndarray,
              num_series: int, max_len: Optional[int] = None) -> "SeriesMatrix":
        """Build from flat arrays sorted by (series_id, ts). Rows whose
        series_id is outside [0, num_series) are dropped."""
        sel = (series_ids >= 0) & (series_ids < num_series)
        series_ids, ts, values = series_ids[sel], ts[sel], values[sel]
        counts = np.bincount(series_ids, minlength=num_series)
        longest = int(counts.max(initial=0))
        if max_len is not None and max_len < longest:
            raise ValueError(
                f"max_len={max_len} smaller than longest series ({longest} rows)")
        L = int(max_len if max_len is not None else max(longest, 1))
        # bucket L to powers of two, as the reference does
        L = 1 << (L - 1).bit_length() if L > 1 else 1
        ts2d = np.full((num_series, L), TS_PAD, dtype=np.int64)
        val2d = np.zeros((num_series, L), dtype=values.dtype)
        offsets = np.zeros(num_series + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        col = np.arange(len(series_ids)) - offsets[series_ids]
        ts2d[series_ids, col] = ts
        val2d[series_ids, col] = values
        return SeriesMatrix(ts2d, val2d, counts.astype(np.int32))

    def device_arrays(self, base: Optional[int] = None):
        """Return (ts, values, lengths, base) ready for device transfer.

        When the time span fits, timestamps are rebased to int32 offsets
        from `base` (padding becomes int32 max, preserving the sentinel
        ordering); callers must rebase query times by the same base.
        Otherwise the int64 timestamps come back unchanged (base 0)."""
        valid = self.ts != TS_PAD
        if base is None:
            base = int(self.ts[valid].min()) if valid.any() else 0
        span_ok = True
        if valid.any():
            span_ok = (int(self.ts[valid].max()) - base) < 2**31 - 1 and \
                base <= int(self.ts[valid].min())
        if span_ok:
            rel = np.where(valid, self.ts - base, np.iinfo(np.int32).max)
            return rel.astype(np.int32), self.values, self.lengths, base
        return self.ts, self.values, self.lengths, 0


# ---------------------------------------------------------------------------
# host/device plumbing
# ---------------------------------------------------------------------------

def _device_of(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device(DEFAULT_DEVICE)


def _to_dev(x, device: torch.device) -> torch.Tensor:
    """Tensor on `device` in the x64-off regime: float64 → float32 and
    int64 → int32 (host int64 timestamps are rebased before this)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    elif x.dtype == torch.int64:
        x = x.to(torch.int32)
    return x.to(device)


def _f32(x) -> float:
    """A host scalar rounded to float32, as the reference's traced f32
    scalars are (so host-side arithmetic rounds where it does)."""
    return float(np.float32(x))


def _grid_ends(t0: int, step: int, nsteps: int, like: torch.Tensor
               ) -> torch.Tensor:
    """t0 + k*step for k < nsteps in `like`'s dtype and device."""
    k = torch.arange(int(nsteps), dtype=torch.int64, device=like.device)
    return (k * int(step) + int(t0)).to(like.dtype)


def _gather(row2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather row2d[s, idx[s, t]] → [S, T] (idx clipped by caller)."""
    return torch.gather(row2d, 1, idx.to(torch.int64))


def _zcol(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# window bounds
# ---------------------------------------------------------------------------

def _searchsorted_right(ts2d: torch.Tensor, ends: torch.Tensor
                        ) -> torch.Tensor:
    """Per-row side='right' searchsorted of one query vector → int32."""
    S = ts2d.shape[0]
    q = ends.to(ts2d.dtype)[None, :].expand(S, -1).contiguous()
    return torch.searchsorted(ts2d.contiguous(), q, right=True) \
        .to(torch.int32)


def _bounds_grid(ts2d: torch.Tensor, t0: int, step: int, nsteps: int,
                 range_ms: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass lo/hi on the grid t0 + k*step (window_bounds' body). The
    window-bounds kernel takes rows of any length; only a grid that does
    not ascend falls back to a binary search."""
    T = int(nsteps)
    if step > 0:
        hi = counts_leq_grid(ts2d, t0, step, T)
        lo = counts_leq_grid(ts2d, t0 - range_ms, step, T)
        return lo, hi
    ends = _grid_ends(t0, step, T, ts2d).to(torch.int64)
    return (_searchsorted_right(ts2d, ends - range_ms),
            _searchsorted_right(ts2d, ends))


def compute_window_bounds(ts2d, t0, *, step: int, range_ms: int,
                          nsteps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standalone window-bounds pass for callers that reuse bounds across
    range functions (rate + avg_over_time over one selector share them).

    When the window is step-aligned (range % step == 0, the common PromQL
    shape) and the extension is not wider than the grid itself, lo is a
    shifted hi: ONE extended count over T + range/step steps replaces the
    two separate passes. Wide-range instant queries keep the two-pass
    form, which is O(nsteps)."""
    ts2d = _to_dev(ts2d, _device_of(ts2d))
    T = int(nsteps)
    step, range_ms = int(step), int(range_ms)
    if (T > 1 and step > 0 and range_ms % step == 0 and range_ms >= 0
            and range_ms // step <= T):
        shift = range_ms // step
        ext = _ext_counts(ts2d, t0, step=step, range_ms=range_ms, nsteps=T)
        return ext[:, :T], ext[:, shift:]
    return _bounds_grid(ts2d, int(t0), step, T, range_ms)


def window_bounds(ts2d: torch.Tensor, step_ends, range_ms: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """lo/hi [S, T]: window (end - range, end] as index ranges [lo, hi).
    `step_ends` is a regular grid (t0 + k*step)."""
    ts2d = _to_dev(ts2d, _device_of(ts2d, step_ends))
    ends = torch.as_tensor(step_ends).to(torch.int64)
    T = int(ends.shape[0])
    if T > 1:
        t0, t1 = (int(v) for v in ends[:2].tolist())
        return _bounds_grid(ts2d, t0, t1 - t0, T, int(range_ms))
    ends = ends.to(ts2d.device)
    return (_searchsorted_right(ts2d, ends - int(range_ms)),
            _searchsorted_right(ts2d, ends))


def _rebase_i64_host(ts2d, t0, step=0, nsteps=1, range_ms=0):
    """Host-validating guard against silent int64→int32 narrowing.

    The port computes with int32 timestamps (the reference's x64-off
    regime). Handed a host int64 ts matrix, rebase it to int32 offsets
    from its minimum (remapping TS_PAD to int32 max so padding still sorts
    last) and shift t0 by the same base. Tensors and non-int64 inputs pass
    through untouched.

    The whole quantity range the kernel computes with must fit int32:
    the data span, t0, the last step end t0 + (nsteps-1)*step, and the
    earliest window start t0 - range_ms are all validated (strictly below
    int32 max: a sample rebasing exactly to int32 max would alias the pad
    sentinel and be silently dropped).

    Returns (ts2d, t0)."""
    if not (isinstance(ts2d, np.ndarray) and ts2d.dtype == np.int64):
        return ts2d, t0
    valid = ts2d != TS_PAD
    if valid.any():
        base, hi = int(ts2d[valid].min()), int(ts2d[valid].max())
    else:
        # no samples: rebase the query grid onto itself so evaluation
        # proceeds and every step reports ok=False (not a crash)
        base = hi = int(t0)
    i32 = np.iinfo(np.int32)
    last_end = int(t0) + (int(nsteps) - 1) * int(step)
    bounds = [hi - base, int(t0) - base, last_end - base,
              int(t0) - int(range_ms) - base]
    if any(b >= i32.max or b < i32.min for b in bounds):
        raise ValueError(
            f"timestamp/query span after rebase exceeds int32 "
            f"({min(bounds)}..{max(bounds)}): rebase to region-relative "
            f"offsets first (see SeriesMatrix.device_arrays)")
    rel = np.where(valid, ts2d - base, i32.max).astype(np.int32)
    return rel, np.int32(int(t0) - base)


# ---------------------------------------------------------------------------
# cumsum path
# ---------------------------------------------------------------------------

def range_aggregate_cumsum(
    ts2d, val2d, lengths, t0, step, range_ms, *, op: str, nsteps: int,
    param: float = 0.0,
    bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a cumsum-path range function on the aligned step grid.

    Returns (result [S, T], ok [S, T]) — ok False means "no point for this
    series at this step" (NaN / absent in PromQL terms).

    Host int64 timestamps are rebased (step/range are deltas and stay as
    passed; t0 shifts with the base). `bounds` lets callers reuse one
    `compute_window_bounds` result across several range functions over
    the same selector."""
    ts2d, t0 = _rebase_i64_host(ts2d, t0, step, nsteps, range_ms)
    dev = _device_of(ts2d, val2d, lengths, *(bounds or ()))
    ts2d, val2d, lengths = (_to_dev(x, dev) for x in (ts2d, val2d, lengths))
    t0, step, range_ms = int(t0), int(step), int(range_ms)
    if bounds is None:
        lo, hi = _bounds_grid(ts2d, t0, step, nsteps, range_ms)
    else:
        lo, hi = bounds
    step_ends = _grid_ends(t0, step, nsteps, ts2d)
    return _rac_body(ts2d, val2d, lengths, lo, hi, step_ends, range_ms,
                     op=op, nsteps=nsteps)


def _rac_body(ts2d, val2d, lengths, lo, hi, step_ends, range_ms, *,
              op: str, nsteps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    S, L = ts2d.shape
    idx = torch.arange(L, dtype=torch.int32, device=ts2d.device)
    valid = idx[None, :] < lengths[:, None]
    fv = val2d.dtype
    count = (hi - lo).to(torch.int32)
    ok1 = count >= 1
    hi1 = torch.clamp(hi - 1, min=0)

    def pick_first():
        return _gather(val2d, torch.clamp(lo, max=L - 1))

    def pick_last():
        return _gather(val2d, hi1)

    if op in ("count_over_time", "present_over_time"):
        if op == "present_over_time":
            return torch.ones_like(count, dtype=fv), ok1
        return count.to(fv), ok1

    if op in ("sum_over_time", "avg_over_time", "stddev_over_time",
              "stdvar_over_time"):
        vz = torch.where(valid, val2d, 0).to(fv)
        csp = torch.cat([_zcol(vz), torch.cumsum(vz, dim=1)], dim=1)
        wsum = _gather(csp, hi) - _gather(csp, lo)
        if op == "sum_over_time":
            return wsum, ok1
        cnt = torch.clamp(count, min=1).to(fv)
        mean = wsum / cnt
        if op == "avg_over_time":
            return mean, ok1
        cs2p = torch.cat([_zcol(vz), torch.cumsum(vz * vz, dim=1)], dim=1)
        wsq = _gather(cs2p, hi) - _gather(cs2p, lo)
        var = torch.clamp(wsq / cnt - mean * mean, min=0.0)
        if op == "stdvar_over_time":
            return var, ok1
        return torch.sqrt(var), ok1

    if op == "first_over_time":
        return pick_first(), ok1
    if op == "last_over_time":
        return pick_last(), ok1

    if op in ("idelta", "irate_num"):
        ok2 = count >= 2
        last = pick_last()
        prev = _gather(val2d, torch.clamp(hi - 2, min=0))
        if op == "irate_num":
            # prometheus instantValue counter-reset rule: on reset
            # (last < prev) the delta is the last sample alone
            return torch.where(last < prev, last, last - prev), ok2
        return last - prev, ok2

    if op in ("changes", "resets"):
        prev = torch.cat([val2d[:, :1], val2d[:, :-1]], dim=1)
        pair_ok = valid & (idx[None, :] >= 1)
        if op == "changes":
            ind = pair_ok & (val2d != prev)
        else:
            ind = pair_ok & (val2d < prev)
        ci = torch.cumsum(ind.to(torch.int32), dim=1, dtype=torch.int32)
        cip = torch.cat([_zcol(ci), ci], dim=1)
        # pairs (i-1, i) with both endpoints inside [lo, hi)
        cnt = _gather(cip, hi) - _gather(cip, torch.clamp(lo + 1, max=L))
        cnt = torch.where(count >= 1, cnt, 0)
        return cnt.to(fv), ok1

    if op in ("rate", "increase", "delta"):
        first_t = _gather(ts2d, torch.clamp(lo, max=L - 1)).to(fv)
        last_t = _gather(ts2d, hi1).to(fv)
        first_v = pick_first()
        last_v = pick_last()
        if op == "delta":
            raw = last_v - first_v
            is_counter = False
        else:
            # counter-reset correction: adjusted[i] = v[i] + sum of resets<=i
            prev = torch.cat([val2d[:, :1], val2d[:, :-1]], dim=1)
            pair_ok = valid & (idx[None, :] >= 1)
            contrib = torch.where(pair_ok & (val2d < prev), prev, 0).to(fv)
            adj = val2d + torch.cumsum(contrib, dim=1)
            raw = _gather(adj, hi1) - _gather(adj, torch.clamp(lo, max=L - 1))
            is_counter = True
        return _extrapolate(raw, first_t, last_t, first_v, count, step_ends,
                            range_ms, op=op, is_counter=is_counter)

    raise ValueError(f"not a cumsum-path op: {op}")


def _extrapolate(raw, first_t, last_t, first_v, count, step_ends, range_ms,
                 *, op: str, is_counter: bool):
    """Prometheus extrapolation epilogue (extrapolate_rate.rs:100-200),
    shared by the per-op path and the stacked-gather fast path."""
    fv = raw.dtype
    ok2 = count >= 2
    ms = _f32(range_ms)
    ends = step_ends[None, :].to(fv)
    range_start = ends - ms
    dur_to_start = first_t - range_start
    dur_to_end = ends - last_t
    sampled = last_t - first_t
    avg_dur = sampled / torch.clamp(count - 1, min=1).to(fv)
    threshold = avg_dur * 1.1
    if is_counter:
        # cap extrapolation below zero for counters (only meaningful when
        # the first sample is non-negative, per extrapolate_rate.rs)
        dur_to_zero = torch.where(
            (raw > 0) & (first_v >= 0),
            sampled * (first_v / torch.where(raw == 0, 1.0, raw)),
            float("inf"))
        dur_to_start = torch.minimum(dur_to_start, dur_to_zero)
    ext_start = torch.where(dur_to_start < threshold, dur_to_start,
                            avg_dur / 2)
    ext_end = torch.where(dur_to_end < threshold, dur_to_end, avg_dur / 2)
    factor = (sampled + ext_start + ext_end) / \
        torch.where(sampled == 0, 1.0, sampled)
    out = raw * factor
    if op == "rate":
        out = out / _f32(np.float32(ms) / np.float32(1000.0))
    return out, ok2 & (sampled > 0)


# ---------------------------------------------------------------------------
# gather path
# ---------------------------------------------------------------------------

def range_aggregate_gather(
    ts2d, val2d, t0, step, range_ms, *, op: str, nsteps: int, maxw: int,
    param: float = 0.0, param2: float = 0.0, series_block: int = 128,
    bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather-path range functions (host int64 ts rebased, see
    `range_aggregate_cumsum`; `bounds` reuses a `compute_window_bounds`
    result)."""
    ts2d, t0 = _rebase_i64_host(ts2d, t0, step, nsteps, range_ms)
    dev = _device_of(ts2d, val2d, *(bounds or ()))
    ts2d, val2d = _to_dev(ts2d, dev), _to_dev(val2d, dev)
    pre_lo, pre_hi = bounds if bounds is not None else (None, None)
    return _rag_body(ts2d, val2d, int(t0), int(step), int(range_ms),
                     pre_lo, pre_hi, op=op, nsteps=nsteps, maxw=maxw,
                     param=param, param2=param2, series_block=series_block)


def _rag_body(
    ts2d: torch.Tensor, val2d: torch.Tensor,
    t0: int, step: int, range_ms: int, pre_lo, pre_hi, *, op: str,
    nsteps: int, maxw: int, param: float = 0.0, param2: float = 0.0,
    series_block: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather-path range functions: each window materializes ≤ maxw samples.

    Row validity comes from the TS_PAD sentinel (padded slots sort last and
    fall outside every window), so no lengths array is needed. Windows longer
    than maxw are truncated to their most recent maxw samples. Processed in
    series blocks to bound the [B, T, maxw] working set; each block gathers
    its windows by advanced indexing, never a [B, T, L] broadcast."""
    S, L = ts2d.shape
    dev = ts2d.device
    step_ends = _grid_ends(t0, step, nsteps, ts2d)
    w = torch.arange(maxw, dtype=torch.int32, device=dev)
    fv = val2d.dtype
    outs, oks = [], []
    for s0 in range(0, S, series_block):
        tsb = ts2d[s0:s0 + series_block]
        valb = val2d[s0:s0 + series_block]
        if pre_lo is not None:
            lo = pre_lo[s0:s0 + series_block]
            hi = pre_hi[s0:s0 + series_block]
        else:
            lo, hi = _bounds_grid(tsb, t0, step, nsteps, range_ms)
        lo = torch.maximum(lo, hi - maxw)
        widx = lo[:, :, None] + w[None, None, :]            # [B, T, W]
        inwin = widx < hi[:, :, None]
        widx_c = torch.clamp(widx, max=L - 1).to(torch.int64)
        rows = torch.arange(tsb.shape[0], device=dev)[:, None, None]
        vals = valb[rows, widx_c]
        tvals = tsb[rows, widx_c]
        count = (hi - lo).to(torch.int32)
        r, ok = _rag_block(op, vals, tvals, inwin, count, step_ends, fv,
                           param, param2)
        outs.append(r)
        oks.append(ok)
    if not outs:
        return (torch.zeros((0, nsteps), dtype=fv, device=dev),
                torch.zeros((0, nsteps), dtype=torch.bool, device=dev))
    return torch.cat(outs, dim=0), torch.cat(oks, dim=0)


def _rag_block(op, vals, tvals, inwin, count, step_ends, fv, param, param2):
    ok1 = count >= 1
    if op == "min_over_time":
        return torch.where(inwin, vals, float("inf")).amin(dim=2), ok1
    if op == "max_over_time":
        return torch.where(inwin, vals, float("-inf")).amax(dim=2), ok1
    if op == "mad_over_time":
        med = _masked_quantile(vals, inwin, 0.5)
        dev = torch.abs(vals - med[:, :, None])
        return _masked_quantile(dev, inwin, 0.5), ok1
    if op == "quantile_over_time":
        return _masked_quantile(vals, inwin, param), ok1
    if op in ("deriv", "predict_linear"):
        ok2 = count >= 2
        # least-squares slope with times centered on the window end
        t_sec = (tvals.to(fv) - step_ends[None, :, None].to(fv)) / 1000.0
        m = inwin.to(fv)
        n = torch.clamp(torch.sum(m, dim=2), min=1)
        sx = torch.sum(t_sec * m, dim=2)
        sy = torch.sum(vals * m, dim=2)
        sxx = torch.sum(t_sec * t_sec * m, dim=2)
        sxy = torch.sum(t_sec * vals * m, dim=2)
        denom = n * sxx - sx * sx
        slope = torch.where(denom != 0, (n * sxy - sx * sy) /
                            torch.where(denom == 0, 1.0, denom),
                            float("nan"))
        if op == "deriv":
            return slope, ok2
        intercept = (sy - slope * sx) / n
        return intercept + slope * _f32(param), ok2
    if op == "holt_winters":
        return _holt_winters(vals, inwin, param, param2), count >= 2
    raise ValueError(f"not a gather-path op: {op}")


def _masked_quantile(vals: torch.Tensor, mask: torch.Tensor, q
                     ) -> torch.Tensor:
    """Quantile along the last axis ignoring masked entries (sort-based,
    linear interpolation, matching Prometheus quantile semantics)."""
    big = torch.where(mask, vals, float("inf"))
    svals = torch.sort(big, dim=-1).values
    n = torch.sum(mask, dim=-1, dtype=torch.int32)
    fv = vals.dtype
    W = vals.shape[-1]
    pos = (n.to(fv) - 1) * _f32(q)
    lo_i = torch.clamp(torch.floor(pos).to(torch.int32), 0, W - 1)
    hi_i = torch.clamp(lo_i + 1, 0, W - 1)
    frac = pos - lo_i.to(fv)
    lo_v = torch.gather(svals, -1, lo_i[..., None].to(torch.int64))[..., 0]
    hi_c = torch.minimum(hi_i, torch.clamp(n - 1, min=0))
    hi_v = torch.gather(svals, -1, hi_c[..., None].to(torch.int64))[..., 0]
    return lo_v + (hi_v - lo_v) * frac


def _holt_winters(vals: torch.Tensor, mask: torch.Tensor, sf, tf
                  ) -> torch.Tensor:
    """Holt-Winters double exponential smoothing over each window.

    sf = smoothing factor, tf = trend factor (both in (0,1)); sequential
    over the ≤ maxw window positions (reference:
    src/promql/src/functions/holt_winters.rs). Coefficients are float32,
    as the reference's traced scalars are."""
    one = np.float32(1.0)
    sf32, tf32 = np.float32(sf), np.float32(tf)
    a, a1 = float(sf32), float(one - sf32)
    c, c1 = float(tf32), float(one - tf32)
    x0 = vals[..., 0]
    x1 = torch.where(mask[..., 1], vals[..., 1], x0)
    s, b = x1, x1 - x0
    for i in range(2, vals.shape[-1]):
        x, m = vals[..., i], mask[..., i]
        s_new = a * x + a1 * (s + b)
        b_new = c * (s_new - s) + c1 * b
        s = torch.where(m, s_new, s)
        b = torch.where(m, b_new, b)
    return s


# ---------------------------------------------------------------------------
# Aligned-window shared evaluation (the PromQL dashboard fast path)
# ---------------------------------------------------------------------------
# When the window is a multiple of the step (rate(x[5m]) at 1m step — the
# common dashboard shape), every per-(series, step) quantity the cumsum-op
# family needs is a value at either index lo[k] or hi[k]-1, and lo is a
# shifted view of hi over an EXTENDED grid. ONE stacked gather at the
# extended grid serves every op — rate + avg_over_time + ... over the same
# selector share the bounds pass, the cumsums, and the gather, leaving only
# [S, T] vector epilogues per op.

# tier-A channels (prefix/instant values)
_CH_CSP, _CH_TS_PREV, _CH_TS_AT, _CH_VAL_PREV, _CH_VAL_AT, _CH_VAL_PREV2 = \
    range(6)


def _gather_stack(stack: torch.Tensor, ext: torch.Tensor, L: int
                  ) -> torch.Tensor:
    """stack [S, L+1, C] at positions min(ext, L) → [S, T_ext, C]."""
    e = torch.clamp(ext, max=L).to(torch.int64)
    return torch.gather(stack, 1, e[:, :, None].expand(-1, -1, stack.shape[2]))


def _stack_prefix(ts2d, val2d, lengths, ext):
    """Tier A: gather [csp, ts_prev, ts_at, val_prev, val_at, val_prev2]
    at the extended-grid positions; X_at[e] = X[min(e, L-1)],
    X_prev[e] = X[max(e-1, 0)], X_prev2[e] = X[max(e-2, 0)]."""
    S, L = ts2d.shape
    fv = val2d.dtype
    idx = torch.arange(L, dtype=torch.int32, device=ts2d.device)
    valid = idx[None, :] < lengths[:, None]
    vz = torch.where(valid, val2d, 0).to(fv)
    csp = torch.cat([_zcol(vz), torch.cumsum(vz, dim=1)], dim=1)
    tsf = ts2d.to(fv)
    stack = torch.stack([
        csp,
        torch.cat([tsf[:, :1], tsf], dim=1),
        torch.cat([tsf, tsf[:, -1:]], dim=1),
        torch.cat([val2d[:, :1], val2d], dim=1).to(fv),
        torch.cat([val2d, val2d[:, -1:]], dim=1).to(fv),
        torch.cat([val2d[:, :1], val2d[:, :1], val2d[:, :-1]], dim=1).to(fv),
    ], dim=-1)
    return _gather_stack(stack, ext, L)


def _stack_counter(ts2d, val2d, lengths, ext):
    """Tier B: counter-reset-adjusted values [adj_prev, adj_at]."""
    S, L = ts2d.shape
    fv = val2d.dtype
    idx = torch.arange(L, dtype=torch.int32, device=ts2d.device)
    valid = idx[None, :] < lengths[:, None]
    prev = torch.cat([val2d[:, :1], val2d[:, :-1]], dim=1)
    pair_ok = valid & (idx[None, :] >= 1)
    contrib = torch.where(pair_ok & (val2d < prev), prev, 0).to(fv)
    adj = val2d + torch.cumsum(contrib, dim=1)
    stack = torch.stack([
        torch.cat([adj[:, :1], adj], dim=1),
        torch.cat([adj, adj[:, -1:]], dim=1),
    ], dim=-1)
    return _gather_stack(stack, ext, L)


def _stack_sq(ts2d, val2d, lengths, ext):
    """Tier C: squared-value prefix (stddev/stdvar only)."""
    S, L = ts2d.shape
    fv = val2d.dtype
    idx = torch.arange(L, dtype=torch.int32, device=ts2d.device)
    valid = idx[None, :] < lengths[:, None]
    vz = torch.where(valid, val2d, 0).to(fv)
    csp2 = torch.cat([_zcol(vz), torch.cumsum(vz * vz, dim=1)], dim=1)
    return _gather_stack(csp2[:, :, None], ext, L)


def _ext_counts(ts2d, t0, *, step: int, range_ms: int, nsteps: int):
    """Counts at the extended grid [t0 - range, ..., t0 + (nsteps-1)*step]:
    lo = ext[:, :nsteps], hi = ext[:, shift:] for shift = range // step."""
    shift = range_ms // step
    return counts_leq_grid(ts2d, int(t0) - int(range_ms), step,
                           nsteps + shift)


def _op_from_stack(ga, gb, gc, lo, hi, t0, step, range_ms, *,
                   op: str, nsteps: int, shift: int):
    T = nsteps
    fv = ga.dtype
    count = (hi - lo).to(torch.int32)
    ok1 = count >= 1

    def lo_of(x):
        return x[:, :T]

    def hi_of(x):
        return x[:, shift:]

    def A(c):
        return ga[..., c]

    if op == "sum_over_time":
        return hi_of(A(_CH_CSP)) - lo_of(A(_CH_CSP)), ok1
    if op in ("avg_over_time", "stddev_over_time", "stdvar_over_time"):
        wsum = hi_of(A(_CH_CSP)) - lo_of(A(_CH_CSP))
        cnt = torch.clamp(count, min=1).to(fv)
        mean = wsum / cnt
        if op == "avg_over_time":
            return mean, ok1
        csp2 = gc[..., 0]
        wsq = hi_of(csp2) - lo_of(csp2)
        var = torch.clamp(wsq / cnt - mean * mean, min=0.0)
        return (var if op == "stdvar_over_time" else torch.sqrt(var)), ok1
    if op == "first_over_time":
        return lo_of(A(_CH_VAL_AT)), ok1
    if op == "last_over_time":
        return hi_of(A(_CH_VAL_PREV)), ok1
    if op in ("idelta", "irate_num"):
        ok2 = count >= 2
        last = hi_of(A(_CH_VAL_PREV))
        prev = hi_of(A(_CH_VAL_PREV2))
        if op == "irate_num":
            return torch.where(last < prev, last, last - prev), ok2
        return last - prev, ok2
    if op in ("rate", "increase", "delta"):
        step_ends = _grid_ends(t0, step, T, lo)     # int32, lo's device
        first_t = lo_of(A(_CH_TS_AT))
        last_t = hi_of(A(_CH_TS_PREV))
        first_v = lo_of(A(_CH_VAL_AT))
        last_v = hi_of(A(_CH_VAL_PREV))
        if op == "delta":
            raw = last_v - first_v
            is_counter = False
        else:
            raw = hi_of(gb[..., 0]) - lo_of(gb[..., 1])
            is_counter = True
        return _extrapolate(raw, first_t, last_t, first_v, count, step_ends,
                            range_ms, op=op, is_counter=is_counter)
    raise ValueError(f"not a stack-path op: {op}")


def _count_from_bounds(lo, hi, *, op: str, fv):
    # fv = value dtype, so results match the non-aligned path's dtype
    count = (hi - lo).to(torch.int32)
    ok1 = count >= 1
    if op == "present_over_time":
        return torch.ones_like(count, dtype=fv), ok1
    return count.to(fv), ok1


class AlignedWindowEval:
    """Shared-state evaluator for cumsum-path range functions over one
    series matrix and one step-aligned grid (range % step == 0).

    Bounds, cumsums, and the stacked gather are computed once and cached;
    each op adds only a [S, T] vector epilogue. The PromQL engine caches
    one of these per (selector, window) within an evaluation."""

    def __init__(self, ts2d, val2d, lengths, t0, step, range_ms, nsteps):
        step, range_ms, nsteps = int(step), int(range_ms), int(nsteps)
        if step <= 0 or range_ms < 0 or range_ms % step:
            raise ValueError("AlignedWindowEval needs range % step == 0")
        ts2d, t0 = _rebase_i64_host(ts2d, t0, step, nsteps, range_ms)
        dev = _device_of(ts2d, val2d, lengths)
        self.ts2d, self.val2d, self.lengths = \
            (_to_dev(x, dev) for x in (ts2d, val2d, lengths))
        self.t0, self.step, self.range_ms = int(t0), step, range_ms
        self.nsteps = nsteps
        self.shift = range_ms // step
        self._ext = None
        self._ga = self._gb = self._gc = None

    def ext(self):
        if self._ext is None:
            self._ext = _ext_counts(self.ts2d, self.t0, step=self.step,
                                    range_ms=self.range_ms,
                                    nsteps=self.nsteps)
        return self._ext

    def bounds(self) -> Tuple[torch.Tensor, torch.Tensor]:
        ext = self.ext()
        return ext[:, :self.nsteps], ext[:, self.shift:]

    def eval(self, op: str) -> Tuple[torch.Tensor, torch.Tensor]:
        if op not in CUMSUM_OPS:
            raise ValueError(f"not a cumsum-path op: {op}")
        lo, hi = self.bounds()
        if op in ("count_over_time", "present_over_time"):
            return _count_from_bounds(lo, hi, op=op, fv=self.val2d.dtype)
        if op in ("changes", "resets"):
            # outside the stack family; still shares the bounds pass
            return range_aggregate_cumsum(
                self.ts2d, self.val2d, self.lengths, self.t0, self.step,
                self.range_ms, op=op, nsteps=self.nsteps, bounds=(lo, hi))
        if self._ga is None:
            self._ga = _stack_prefix(self.ts2d, self.val2d, self.lengths,
                                     self.ext())
        gb = gc = None
        if op in ("rate", "increase"):
            if self._gb is None:
                self._gb = _stack_counter(self.ts2d, self.val2d,
                                          self.lengths, self.ext())
            gb = self._gb
        if op in ("stddev_over_time", "stdvar_over_time"):
            if self._gc is None:
                self._gc = _stack_sq(self.ts2d, self.val2d, self.lengths,
                                     self.ext())
            gc = self._gc
        return _op_from_stack(self._ga, gb, gc, lo, hi, self.t0, self.step,
                              self.range_ms, op=op, nsteps=self.nsteps,
                              shift=self.shift)


# ---------------------------------------------------------------------------
# instant selection
# ---------------------------------------------------------------------------

def instant_select(ts2d, val2d, t0, step, lookback_ms, *, nsteps: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """InstantManipulate: at each step pick the latest sample within the
    lookback window [t - lookback, t] (reference:
    src/promql/src/extension_plan/instant_manipulate.rs:46). Host int64
    ts rebased, see `range_aggregate_cumsum`."""
    ts2d, t0 = _rebase_i64_host(ts2d, t0, step, nsteps, lookback_ms)
    dev = _device_of(ts2d, val2d)
    ts2d, val2d = _to_dev(ts2d, dev), _to_dev(val2d, dev)
    step_ends = _grid_ends(int(t0), int(step), nsteps, ts2d)
    hi = _searchsorted_right(ts2d, step_ends)
    hi1 = torch.clamp(hi - 1, min=0)
    last_t = _gather(ts2d, hi1)
    ok = (hi >= 1) & (last_t.to(torch.int64) >=
                      step_ends.to(torch.int64)[None, :] - int(lookback_ms))
    return _gather(val2d, hi1), ok
