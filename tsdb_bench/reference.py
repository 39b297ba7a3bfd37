"""The plain reference: TSBS group-by answers in float64 NumPy, and the
comparison that decides `correct`.

The brute force of `chip_smoke.py` (`sql_expected`, `compare_sql`,
`sum_bound`), cut to the statements the mixes send and frozen here. It
works from the generated arrays alone and imports numpy only: nothing of
the program, and nothing that the program made.

The configuration stores DOUBLE fields and mirrors them on the device as
float32. So an answer is held to:
- keys (bucket, hostname) and the row count: exact;
- `max`: equal to the float32 rounding of the float64 answer;
- `avg`: within `sum_bound` over the count: each value rounds to float32
  (u32 |x|), the run accumulates in float64 (c u64 sum |x|) and rounds
  once (u32 |S|); then the division (4 u64 |avg|).

The compared numbers are `mismatches` (cells that differ where they must
be exact, and rows missing or extra) and `worst`, the largest
|answer - reference| / bound over the `avg` cells.

`answer(..., precision="bfloat16")` is the control: the same reference
with every value rounded to bfloat16 and sums kept in float32, the step
below the float32 mirror that the configuration states.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

U32 = 2.0 ** -24                   # float32 unit roundoff
U64 = 2.0 ** -53                   # float64 unit roundoff


def sum_bound(S, A, c):
    """Bound on the program's float32-mirrored run sum of c float64
    values with exact sum S and absolute sum A."""
    return U32 * A + U32 * np.abs(S) + 2 * c * U64 * A


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """x rounded to the nearest bfloat16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return r.view(np.float32)


class Data:
    """The rows a statement may read: `vals` float64 [fields, n, hosts],
    time-major, the interval i at start_ms + i * interval_ms."""

    def __init__(self, vals: np.ndarray, fields: Sequence[str],
                 start_ms: int, interval_ms: int):
        self.vals = vals
        self.field_index = {f: i for i, f in enumerate(fields)}
        self.start_ms = int(start_ms)
        self.interval_ms = int(interval_ms)
        H = vals.shape[2]
        # ORDER BY hostname sorts the names as strings
        self.by_name = np.asarray(sorted(range(H),
                                         key=lambda h: f"host_{h}"))

    def rows(self, a: int, b: int):
        """The interval indices [lo, hi) of the timestamps in [a, b)."""
        iv, t0, n = self.interval_ms, self.start_ms, self.vals.shape[1]
        lo = min(max(0, -(-(a - t0) // iv)), n)
        hi = min(max(0, -(-(b - t0) // iv)), n)
        return lo, max(lo, hi)


def answer(data: Data, stmt: dict, precision: str = "float64") -> dict:
    """{"bucket": int64 [G], "host": object [G], "values": [float64 [G]]
    per field, "bounds": [float64 [G] or None] per field}, rows ordered
    by bucket, then hostname as a string."""
    lo, hi = data.rows(stmt["a"], stmt["b"])
    hosts = data.by_name if stmt["hosts"] is None else np.asarray(
        sorted(stmt["hosts"], key=lambda h: f"host_{h}"))
    B = stmt["bucket_ms"]
    ts = data.start_ms + np.arange(lo, hi, dtype=np.int64) * \
        data.interval_ms
    bid = ts // B
    starts = np.flatnonzero(np.r_[True, bid[1:] != bid[:-1]]) \
        if len(bid) else np.zeros(0, dtype=np.int64)
    counts = np.diff(np.r_[starts, len(bid)]).astype(np.float64)
    nb, h = len(starts), len(hosts)
    values: List[np.ndarray] = []
    bounds: List[Optional[np.ndarray]] = []
    for f in stmt["fields"]:
        X = data.vals[data.field_index[f], lo:hi][:, hosts]
        if precision == "bfloat16":
            X = to_bfloat16(X)
        elif precision != "float64":
            raise ValueError(f"unknown precision {precision!r}")
        if nb == 0:
            values.append(np.zeros(0))
            bounds.append(np.zeros(0) if stmt["agg"] == "avg" else None)
            continue
        if stmt["agg"] == "avg":
            S = np.add.reduceat(X, starts, axis=0)
            c = counts[:, None]
            v = S / c
            if precision == "float64":
                bounds.append((sum_bound(S, S, c) / c +
                               4 * U64 * np.abs(v)).ravel())
            else:
                bounds.append(None)
        elif stmt["agg"] == "max":
            v = np.maximum.reduceat(X, starts, axis=0)
            bounds.append(None)
        else:
            raise ValueError(f"unknown aggregate {stmt['agg']!r}")
        values.append(np.asarray(v, dtype=np.float64).ravel())
    return {"bucket": np.repeat(bid[starts] * B, h),
            "host": np.tile(np.asarray([f"host_{x}" for x in hosts],
                                       dtype=object), nb),
            "values": values, "bounds": bounds}


def compare(got: dict, want: dict, agg: str) -> Dict[str, float]:
    """{"mismatches": exact cells and rows that differ, "worst": the
    largest |got - want| / bound of an avg cell}. `got` has the keys of
    `answer` without the bounds."""
    G = len(want["bucket"])
    if len(got["bucket"]) != G or len(got["values"]) != len(want["values"]):
        return {"mismatches": float(max(G, len(got["bucket"])) or 1),
                "worst": 0.0}
    mism = int((np.asarray(got["bucket"], dtype=np.int64) !=
                want["bucket"]).sum())
    mism += int((np.asarray(got["host"], dtype=object) !=
                 want["host"]).sum())
    worst = 0.0
    for g, w, bd in zip(got["values"], want["values"], want["bounds"]):
        g = np.asarray(g, dtype=np.float64)
        if agg == "max":
            mism += int((g != w.astype(np.float32).astype(np.float64))
                        .sum())
            continue
        d = np.abs(g - w)
        if np.isnan(d).any():
            mism += int(np.isnan(d).sum())
            d = np.nan_to_num(d, nan=0.0)
        if len(d):
            # a bound of 0 (every value 0, exact in float32) allows none
            ratio = np.divide(d, bd, out=np.where(d > 0, np.inf, 0.0),
                              where=bd > 0)
            worst = max(worst, float(ratio.max()))
    return {"mismatches": float(mism), "worst": worst}
