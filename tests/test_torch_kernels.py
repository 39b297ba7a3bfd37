"""Differential tests: the port's sorted-segment group-by (the plain
version of the segment-moments kernel, which its wrapper runs for CPU
tensors) against the JAX package's `sorted_grouped_aggregate`, on the
same numpy inputs, with and without host run ends.

Tolerances:
- counts, min, max, first and last: exact (NaN where the reference has
  NaN), including the empty-group identities;
- int32 sums: exact (both wrap mod 2^32);
- float sums: the reference takes float32 prefix differences over the
  whole array, so its error per group is about eps32 times the global
  prefix, not the group's sum; the port accumulates each run in float64.
  We allow |port - ref| <= 1e-5 |ref| + 8 eps32 P, with P the sum of |x|
  (|x|^2 for sum_sq) over every counted row of the array; averages get
  that over the group's count; variances the bound propagated through
  (sq - s^2/c) / (c - 1).

Reference programs are shared across cases: every case at one shape runs
the same op tuple, so the JAX package compiles once per shape.
"""

import numpy as np
import pytest
import torch

from greptimedb_tpu.ops import kernels as R
from greptimedb_tpu_torch.ops import kernels as K

EPS32 = 2.0 ** -24
#: one op tuple for every case: float moments, then the int32 column's
OPS = ("count", "sum", "sum_sq", "min", "max", "first", "last", "avg",
       "stddev", "variance", "sum", "min", "max", "first", "last", "avg")
INT_FROM = 10           # OPS[INT_FROM:] read the int32 column


def _case(name):
    """(gids, ends, mask, ts, x float32, xi int32, col mask) per case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name in ("uniform", "zipf", "all-masked", "one-run", "ties"):
        n, G = 50_000, 97
        if name == "zipf":
            raw = rng.zipf(1.5, n) % G
        elif name == "one-run":
            raw = np.zeros(n, np.int64)
        else:
            raw = rng.integers(0, G, n)
    elif name == "high-card-fat-run":
        n, G = 120_000, 9000
        raw = np.concatenate([rng.integers(0, G, n - 5000),
                              np.full(5000, 1234)])
    else:
        # runs ending on and beside 1024-row and 32-row edges, empty and
        # one-row runs, then the rest of the rows over the other groups
        # (the same shape as the cases above: one reference program)
        n, G = 50_000, 97
        sizes = [1023, 1, 1024, 0, 2046, 3, 0, 2053, 1, 32, 33, 4096]
        head = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)])
        raw = np.concatenate([head, rng.integers(len(sizes), G,
                                                 n - len(head))])
    gids = np.sort(raw).astype(np.int32)
    ends = np.cumsum(np.bincount(gids, minlength=G),
                     dtype=np.int64).astype(np.int32)
    mask = rng.random(n) > 0.15
    if name == "all-masked":
        mask[:] = False
    if name in ("ties", "high-card-fat-run"):
        ts = rng.integers(0, 50, n).astype(np.int32)      # unsorted, ties
    else:
        ts = rng.permutation(n).astype(np.int32)          # unsorted
    x = (rng.normal(size=n) * 50).astype(np.float32)
    xi = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)  # sums wrap
    cm = rng.random(n) > 0.1                              # column nulls
    return gids, ends, G, mask, ts, x, xi, cm


def _reference(gids, ends, G, mask, ts, vals, cms, with_ends):
    kw = {"ends": ends} if with_ends else {}
    if with_ends and G > R._SEG_HIGH_CARD_THRESHOLD:
        kw["seg_len_k"] = R.seg_len_bucket(int(np.diff(ends, prepend=0)
                                               .max()))
    res, counts = R.sorted_grouped_aggregate(
        gids, mask, ts, vals, cms, num_groups=G, ops=OPS,
        has_col_masks=True, **kw)
    return [np.asarray(r) for r in res], np.asarray(counts)


def _port(gids, ends, G, mask, ts, vals, cms, host_ends):
    T = torch.as_tensor
    before = K.segment_moments.launches
    res, counts = K.sorted_grouped_aggregate(
        None if host_ends else T(gids), T(mask), T(ts),
        tuple(T(v) for v in vals), tuple(T(c) for c in cms),
        num_groups=G, ops=OPS, has_col_masks=True,
        ends=ends if host_ends else None)
    assert K.segment_moments.launches == before   # CPU: the plain version
    return [r.numpy() for r in res], counts.numpy()


def _sum_tol(ref, v, m, square=False):
    a = np.abs(v.astype(np.float64))
    P = float(((a * a) if square else a)[m].sum())
    return 1e-5 * np.abs(ref.astype(np.float64)) + 8 * EPS32 * P


@pytest.mark.parametrize("name,with_ends", [
    (name, True) for name in ("uniform", "zipf", "all-masked", "one-run",
                              "ties", "block-edges", "high-card-fat-run")
] + [(name, False) for name in ("uniform", "zipf", "one-run")])
def test_sorted_grouped_aggregate_matches_reference(name, with_ends):
    gids, ends, G, mask, ts, x, xi, cm = _case(name)
    vals = tuple(x if i < INT_FROM else xi for i in range(len(OPS)))
    cms = (cm,) * len(OPS)
    want, want_c = _reference(gids, ends, G, mask, ts, vals, cms,
                              with_ends)
    got, got_c = _port(gids, ends, G, mask, ts, vals, cms, with_ends)
    np.testing.assert_array_equal(got_c, want_c)
    m = mask & cm
    c = np.asarray(want[0], np.float64)
    for i, (op, g, w) in enumerate(zip(OPS, got, want)):
        v = vals[i]
        assert g.dtype == w.dtype, (op, g.dtype, w.dtype)
        if op in ("count", "min", "max", "first", "last") or \
                (op == "sum" and i >= INT_FROM) or \
                (op == "avg" and i >= INT_FROM):
            np.testing.assert_array_equal(g, w, err_msg=f"{op}[{i}]")
            continue
        g64, w64 = g.astype(np.float64), w.astype(np.float64)
        if op in ("sum", "sum_sq"):
            tol = _sum_tol(w, v, m, square=op == "sum_sq")
        elif op == "avg":
            tol = _sum_tol(w, v, m) / np.maximum(c, 1)
        else:                             # stddev / variance
            d = v.astype(np.float64) - (v[m].astype(np.float64).mean()
                                        if m.any() else 0.0)
            e_s = 8 * EPS32 * np.abs(d)[m].sum()
            e_sq = 8 * EPS32 * (d * d)[m].sum()
            mean = np.abs(np.where(c > 0, np.bincount(
                np.repeat(np.arange(G), np.diff(ends, prepend=0)),
                np.where(m, d, 0.0), G) / np.maximum(c, 1), 0.0))
            var_tol = (e_sq + 2 * mean * e_s + e_s ** 2 /
                       np.maximum(c, 1)) / np.maximum(c - 1, 1)
            var = np.nan_to_num(w64 ** 2 if op == "stddev" else w64)
            var_tol = var_tol + 1e-5 * var
            tol = np.minimum(np.sqrt(var_tol), var_tol / np.maximum(
                np.sqrt(var), 1e-30)) + 1e-5 * np.nan_to_num(np.abs(w64)) \
                if op == "stddev" else var_tol
        np.testing.assert_array_equal(np.isnan(g64), np.isnan(w64),
                                      err_msg=f"{op}[{i}] NaN pattern")
        ok = ~np.isnan(w64)
        err = np.abs(g64 - w64)[ok]
        assert (err <= np.broadcast_to(tol, g64.shape)[ok]).all(), \
            f"{op}[{i}] {name}: max err {err.max()} over the bound"


def test_small_and_empty_groups_exact():
    """The reference test's tiny case, on the port: empty groups give
    count 0, sum 0, NaN first and the identities for min/max."""
    gids = np.array([0, 0, 0, 2], np.int32)
    mask = torch.tensor([True, True, False, True])
    ts = torch.arange(4, dtype=torch.int32)
    vals = torch.tensor([1.0, 5.0, 100.0, -3.0])
    (s, mn, mx, fst), counts = K.sorted_grouped_aggregate(
        gids, mask, ts, (vals,) * 4, num_groups=4,
        ops=("sum", "min", "max", "first"))
    assert counts.tolist() == [2, 0, 1, 0]
    assert s.tolist() == [6.0, 0.0, -3.0, 0.0]
    assert mn.tolist() == [1.0, float("inf"), -3.0, float("inf")]
    assert mx.tolist() == [5.0, float("-inf"), -3.0, float("-inf")]
    assert fst[0] == 1.0 and fst[2] == -3.0 and torch.isnan(fst[1])


def test_segment_moments_first_last_ties_and_identity_ts():
    """first/last take the extreme (ts, row); rows whose ts is the int32
    identity of the op never win (the reference's found test)."""
    i32 = np.iinfo(np.int32)
    ts = torch.tensor([5, 3, 3, 9, 9, i32.max, i32.min], dtype=torch.int32)
    x = torch.arange(7, dtype=torch.float32)
    ends = torch.tensor([5, 7], dtype=torch.int32)
    mask = torch.ones(7, dtype=torch.bool)
    (f, l), _ = K.segment_moments(ends, mask, ts, (x, x), (None, None),
                                  ("first", "last"))
    assert f[0] == 1.0            # ts 3 twice: the earlier row
    assert l[0] == 4.0            # ts 9 twice: the later row
    assert f[1] == 6.0            # INT32_MAX never wins first
    assert l[1] == 5.0            # INT32_MIN never wins last


def test_segment_moments_nan_propagates_through_min_max():
    x = torch.tensor([1.0, float("nan"), 3.0, 4.0])
    ends = torch.tensor([2, 4], dtype=torch.int32)
    m = torch.ones(4, dtype=torch.bool)
    ts = torch.arange(4, dtype=torch.int32)
    (mn, mx), _ = K.segment_moments(ends, m, ts, (x, x), (None, None),
                                    ("min", "max"))
    assert torch.isnan(mn[0]) and torch.isnan(mx[0])
    assert mn[1] == 3.0 and mx[1] == 4.0


def test_segment_moments_refuses_bad_input():
    ends = torch.tensor([2], dtype=torch.int32)
    m = torch.ones(2, dtype=torch.bool)
    ts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        K.segment_moments(ends.to("meta"), m.to("meta"), ts.to("meta"),
                          (ts.to("meta"),), (None,), ("count",))
    with pytest.raises(ValueError, match="float32/torch.int32"):
        K.segment_moments(ends, m, ts, (ts.double(),), (None,), ("sum",))
    with pytest.raises(ValueError, match="unsupported"):
        K.segment_moments(ends, m, ts, (ts,), (None,), ("median",))
    with pytest.raises(ValueError, match="non-decreasing"):
        K.sorted_grouped_aggregate(None, m, ts, (ts,), num_groups=2,
                                   ops=("count",),
                                   ends=np.array([2, 1], np.int32))


def test_merge_dedup_matches_reference():
    rng = np.random.default_rng(4)
    n = 5000
    s = rng.integers(0, 20, n).astype(np.int32)
    t = rng.integers(0, 300, n).astype(np.int64)
    q = rng.permutation(n).astype(np.int64)
    o = (rng.random(n) < 0.1).astype(np.int8)
    for keep in (False, True):
        np.testing.assert_array_equal(
            K.merge_dedup_numpy(s, t, q, o, keep_deletes=keep),
            R.merge_dedup_numpy(s, t, q, o, keep_deletes=keep))
