"""The port's unsorted group-by (ops/kernels.py: grouped_aggregate over
grouped_moments, and the reference's other XLA helpers ported as torch
ops) against the JAX package's, on the same data.

The same numpy rows (made from a seed) go through
greptimedb_tpu.ops.kernels (JAX on the CPU, x64 off as tests/conftest.py
sets it) and greptimedb_tpu_torch.ops.kernels (torch on the CPU, where
the grouped-moments kernel runs its plain version).

Tolerance: counts, min, max, first, last, every integer result and every
output dtype must be equal. Float sums (sum, avg, stddev, variance) agree
within rtol 3e-4 and atol 1e-4, the reference's own bound for a sharded
sum (__graft_entry__.py): XLA's scatter adds float32 in its order, the
port in float64 rounded once. A float16 column's sum and avg are typed
float16 in both, but the reference adds in float16 (each add rounds, so
its error grows with the group's rows) while the port adds in float64,
rounds to float32 (per shard, the partials added in float32) and then
once to float16. So the port is held to the exact float64 answer e: its
sum within one float16 ulp of e plus the float32 roundings, its avg
within that over the count plus one ulp of the mean; and to the
reference within the reference's own measured error |ref - e| plus the
port's limit (`f16_limits`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greptimedb_tpu.ops import kernels as jk
from greptimedb_tpu_torch.ops import kernels as tk

# tiny tensors: one intra-op thread keeps parallel test workers off
# each other's cores
torch.set_num_threads(1)

RTOL, ATOL = 3e-4, 1e-4
EXACT = ("count", "min", "max", "first", "last")
#: the op groups of tests/test_parallel.py
OP_GROUPS = [("sum", "count", "avg", "min", "max"), ("stddev", "variance"),
             ("first", "last")]


def _rows(seed, n=10_000, groups=37, ts_hi=1_000_000):
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, groups, n).astype(np.int32)
    mask = rng.random(n) > 0.1
    ts = rng.integers(0, ts_hi, n).astype(np.int64)
    vals = rng.normal(size=n).astype(np.float32)
    return rng, gids, mask, ts, vals


def _same(ops, got, want, got_counts, want_counts):
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
    assert got_counts.numpy().dtype == np.asarray(want_counts).dtype
    assert len(got) == len(want) == len(ops)
    for op, g, w in zip(ops, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (op, g.dtype, w.dtype)
        if op in EXACT or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=op)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=op)


@pytest.mark.parametrize("ops", OP_GROUPS, ids=["-".join(g) for g in
                                                OP_GROUPS])
def test_grouped_aggregate_matches_reference(ops):
    _, gids, mask, ts, vals = _rows(7)
    values = tuple(vals for _ in ops)
    got, counts = tk.grouped_aggregate(gids, mask, ts, values,
                                       num_groups=37, ops=ops, device="cpu")
    want, want_counts = jk.grouped_aggregate(gids, mask, ts, values,
                                             num_groups=37, ops=ops)
    _same(ops, got, want, counts, want_counts)


def test_column_masks():
    """Per-op column validity (SQL nulls): a null in one column hides the
    row from that op alone; counts are the row mask's."""
    rng, gids, mask, ts, vals = _rows(11, n=3001, groups=5)
    ops = ("sum", "count", "avg", "min", "max", "first", "last", "stddev")
    cols = tuple(rng.normal(size=len(gids)).astype(np.float32)
                 for _ in ops)
    cms = tuple(rng.random(len(gids)) > 0.4 for _ in ops)
    got, counts = tk.grouped_aggregate(gids, mask, ts, cols, cms,
                                       num_groups=5, ops=ops,
                                       has_col_masks=True, device="cpu")
    want, want_counts = jk.grouped_aggregate(
        gids, mask, ts, cols, cms, num_groups=5, ops=ops,
        has_col_masks=True)
    _same(ops, got, want, counts, want_counts)


def test_empty_groups_and_int32_columns():
    """Groups with no row (past the data, or every row masked) give the
    reference's empty values; int32 sums wrap mod 2^32 alike; an int32
    column keeps its dtype through sum, min, max, first and last."""
    rng = np.random.default_rng(13)
    n, groups = 2048, 9
    gids = rng.integers(0, 5, n).astype(np.int32)        # 5..8 stay empty
    mask = (rng.random(n) > 0.2) & (gids != 3)           # 3: all masked
    ts = rng.integers(-50_000, 50_000, n).astype(np.int32)
    big = rng.integers(2**30, 2**31 - 1, n).astype(np.int32)   # sums wrap
    ops = ("sum", "count", "avg", "min", "max", "first", "last",
           "variance")
    values = tuple(big for _ in ops)
    got, counts = tk.grouped_aggregate(gids, mask, ts, values,
                                       num_groups=groups, ops=ops,
                                       device="cpu")
    want, want_counts = jk.grouped_aggregate(gids, mask, ts, values,
                                             num_groups=groups, ops=ops)
    _same(ops, got, want, counts, want_counts)
    assert int(counts[3]) == 0 and int(counts[7]) == 0
    assert got[0].dtype == torch.int32


def test_first_last_ties_bit_exact():
    """Many rows share the extreme timestamp: both packages take the
    lowest row index among them, so the picks are the same bits, NaN and
    -0.0 included."""
    rng = np.random.default_rng(17)
    n, groups = 4000, 23
    gids = rng.integers(0, groups, n).astype(np.int32)
    mask = rng.random(n) > 0.3
    ts = rng.integers(0, 4, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    vals[rng.random(n) < 0.05] = np.nan
    vals[rng.random(n) < 0.05] = -0.0
    ops = ("first", "last", "min", "max")
    values = (vals,) * len(ops)
    got, _ = tk.grouped_aggregate(gids, mask, ts, values,
                                  num_groups=groups, ops=ops, device="cpu")
    want, _ = jk.grouped_aggregate(gids, mask, ts, values,
                                   num_groups=groups, ops=ops)
    for op, g, w in zip(ops[:2], got, want):
        assert np.array_equal(g.numpy().view(np.int32),
                              np.asarray(w).view(np.int32)), op
    for op, g, w in zip(ops[2:], got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=op)


def test_rows_outside_the_groups_count_nowhere():
    """A group id past num_groups or negative drops its row, as the
    reference's scatter drops it."""
    _, gids, mask, ts, vals = _rows(19, n=1000, groups=6)
    gids = gids.copy()
    gids[::7] = 6
    gids[3::11] = -1
    ops = ("sum", "count", "min", "max", "first", "last", "stddev")
    values = (vals,) * len(ops)
    got, counts = tk.grouped_aggregate(gids, mask, ts, values, num_groups=6,
                                       ops=ops, device="cpu")
    want, want_counts = jk.grouped_aggregate(gids, mask, ts, values,
                                             num_groups=6, ops=ops)
    _same(ops, got, want, counts, want_counts)


#: value dtypes besides the float32 / int32 above: uint32 around 2^31
#: (its unsigned order is not int32's), narrow integers over their whole
#: range (group sums wrap), float16
DTYPES = ("uint32", "int8", "int16", "uint8", "uint16", "float16",
          "int32", "float32")
ALL_OPS = ("count", "sum", "min", "max", "first", "last", "avg", "stddev",
           "variance")
U32 = 2.0 ** -24        # float32 unit roundoff


def dtype_rows(dtype: str, seed: int = 43, n: int = 3000, groups: int = 7):
    """Rows over `groups` groups with two left empty and one all masked,
    ts with ties, and a column of `dtype` that reaches its type's edges."""
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, groups - 2, n).astype(np.int32)
    mask = (rng.random(n) > 0.1) & (gids != 1)
    ts = rng.integers(0, 200, n).astype(np.int32)
    dt = np.dtype(dtype)
    if dt == np.uint32:
        col = rng.integers(2**31 - 2**20, 2**32, n, dtype=np.uint64) \
            .astype(np.uint32)
    elif dt.kind in "iu":
        info = np.iinfo(dt)
        col = rng.integers(int(info.min), int(info.max), n,
                           endpoint=True).astype(dt)
    else:
        col = (rng.normal(size=n) * 100).astype(dt)
    return gids, mask, ts, col


def ulp16(x):
    """The spacing of float16 numbers at |x| (subnormal spacing below
    float16's smallest normal)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -14)))
    return 2.0 ** (e - 10)


def f16_limits(op, want, col, gids, mask, groups, shards=1):
    """Per group, for a float16 column's sum or avg (see the module's
    docstring): the exact answer (float16 values add exactly in float64),
    the port's limit around it (one float16 ulp after float32 partials of
    `shards` shards, each rounded and added in float32) and the limit
    against the reference (its own error from the exact answer plus the
    port's limit)."""
    live = mask & (gids >= 0) & (gids < groups)
    c = np.bincount(gids[live], minlength=groups)[:groups].astype(np.float64)
    x = col[live].astype(np.float64)
    exact = np.bincount(gids[live], x, minlength=groups)[:groups]
    absum = np.bincount(gids[live], np.abs(x), minlength=groups)[:groups]
    lim = ulp16(exact) + 2 * shards * U32 * absum
    if op == "avg":
        exact = exact / np.maximum(c, 1)
        lim = lim / np.maximum(c, 1) + ulp16(exact)
    ref_err = np.abs(want.astype(np.float64) - exact)
    return exact, lim, ref_err + lim


def same_dtyped(ops, got, want, col, gids, mask, groups, shards=1):
    """Each op's result: the same dtype; integers, counts, min, max, first
    and last exactly; float16 sum / avg within `f16_limits` of the exact
    answer and of the reference; the other float results within RTOL /
    ATOL (NaN where NaN)."""
    for op, g, w in zip(ops, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, (op, g.dtype, w.dtype)
        if op in EXACT or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=op)
        elif w.dtype == np.float16 and op in ("sum", "avg"):
            gd, wd = g.astype(np.float64), w.astype(np.float64)
            nan = np.isnan(gd) & np.isnan(wd)
            exact, lim, ref_lim = f16_limits(op, w, col, gids, mask,
                                             groups, shards)
            assert (nan | (np.abs(gd - exact) <= lim)).all(), \
                (op, gd, exact, lim)
            assert (nan | (np.abs(gd - wd) <= ref_lim)).all(), \
                (op, gd, wd, ref_lim)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=op)


@pytest.mark.parametrize("dtype", DTYPES)
def test_value_dtypes_match_reference(dtype):
    """Every op over a column of each value dtype: the reference's dtype
    for each result (float16's avg stays float16), uint32 min / max in
    unsigned order, integer sums wrapped to the column's dtype and avg
    divided from that wrapped sum, an empty group's min / max the dtype's
    own identity."""
    gids, mask, ts, col = dtype_rows(dtype)
    values = (col,) * len(ALL_OPS)
    got, counts = tk.grouped_aggregate(gids, mask, ts, values, num_groups=7,
                                       ops=ALL_OPS, device="cpu")
    want, want_counts = jk.grouped_aggregate(gids, mask, ts, values,
                                             num_groups=7, ops=ALL_OPS)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    same_dtyped(ALL_OPS, [r.numpy() for r in got], want, col, gids, mask, 7)
    assert int(counts[1]) == int(counts[5]) == int(counts[6]) == 0


@pytest.mark.parametrize("dtype", ("uint32", "int8", "int16", "uint8",
                                   "uint16", "float16"))
def test_sorted_grouped_aggregate_refuses_other_dtypes(dtype):
    """The sorted twin takes the scan path's float32 / int32 columns and
    refuses the others with a ValueError that names them (its docstring
    states the refusal) rather than answering in another dtype."""
    gids, mask, ts, col = dtype_rows(dtype, n=200)
    order = np.argsort(gids, kind="stable")
    T = torch.as_tensor
    with pytest.raises(ValueError, match=f"not torch.{dtype}"):
        tk.sorted_grouped_aggregate(
            T(gids[order]), T(mask[order]), T(ts[order]),
            (T(col[order]),), num_groups=7, ops=("sum",))


def test_grouped_moments_keys_and_row_base():
    """The packed first/last keys: (ts << 32) + row_base + row for first,
    (~ts << 32) + ... for last, LLONG_MAX for an empty group; the value
    picks read the row the key names."""
    rng = np.random.default_rng(23)
    n, G, base = 500, 7, 1_000_000
    gids = torch.from_numpy(rng.integers(0, G - 1, n).astype(np.int32))
    mask = torch.from_numpy(rng.random(n) > 0.5)
    ts = torch.from_numpy(rng.integers(-20, 20, n).astype(np.int32))
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    ops = ["first_key", "last_key", "first", "last"]
    res, counts = tk.grouped_moments(gids, mask, ts, [x] * 4, [None] * 4,
                                     ops, num_groups=G, row_base=base)
    for g in range(G):
        rows = np.nonzero(mask.numpy() & (gids.numpy() == g))[0]
        if not len(rows):
            assert int(res[0][g]) == int(res[1][g]) == 2**63 - 1
            assert np.isnan(float(res[2][g])) and np.isnan(float(res[3][g]))
            continue
        t = ts.numpy()[rows].astype(np.int64)
        first = rows[np.lexsort((rows, t))[0]]
        last = rows[np.lexsort((rows, -t))[0]]
        assert int(res[0][g]) == int(ts[first]) * 2**32 + base + first
        assert int(res[1][g]) == (~int(ts[last])) * 2**32 + base + last
        assert float(res[2][g]) == float(x[first])
        assert float(res[3][g]) == float(x[last])
        assert int(counts[g]) == len(rows)


def test_time_bucket_ids_floor_division():
    rng = np.random.default_rng(29)
    ts = rng.integers(-300_000, 1_300_000, 4096).astype(np.int32)
    for origin, stride, nb in ((0, 60_000, 16), (1_000, 7_000, 40),
                               (-90_000, 60_000, 3)):
        got = tk.time_bucket_ids(torch.from_numpy(ts), origin, stride, nb)
        want = np.asarray(jk.time_bucket_ids(jnp.asarray(ts), origin,
                                             stride, nb))
        assert got.numpy().dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_combine_group_ids():
    rng = np.random.default_rng(31)
    tags = rng.integers(0, 500, 1000).astype(np.int32)
    buckets = rng.integers(0, 24, 1000).astype(np.int32)
    got = tk.combine_group_ids(torch.from_numpy(tags),
                               torch.from_numpy(buckets), 24)
    want = np.asarray(jk.combine_group_ids(jnp.asarray(tags),
                                           jnp.asarray(buckets), 24))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", sorted(jk.CMP_OPS))
def test_apply_cmp(op):
    assert tk.CMP_OPS == jk.CMP_OPS
    rng = np.random.default_rng(37)
    for col in (rng.integers(-5, 5, 300).astype(np.int32),
                rng.normal(size=300).astype(np.float32).round(1)):
        a, b = (col[3], col[5]) if op != "isin" else (col[:4], None)
        if op == "between":
            a, b = min(a, b), max(a, b)
        got = tk.apply_cmp(op, torch.from_numpy(col), a, b)
        want = np.asarray(jk.apply_cmp(op, jnp.asarray(col), a, b))
        assert got.numpy().dtype == want.dtype == np.bool_
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tk.apply_cmp("like", torch.zeros(1), 0)


def test_sort_merge_dedup():
    """Order and keep-mask equal the reference's exactly: duplicate
    (series, ts) versions, DELETE winners, invalid rows last, and ties in
    all three keys kept in input order."""
    rng = np.random.default_rng(41)
    n = 3000
    sids = rng.integers(0, 40, n).astype(np.int32)
    ts = rng.integers(0, 30, n).astype(np.int32)
    seq = rng.integers(0, 5, n).astype(np.int32)
    op_types = (rng.random(n) < 0.2).astype(np.int8)
    valid = rng.random(n) > 0.1
    order, keep = tk.sort_merge_dedup(sids, ts, seq, op_types, valid)
    w_order, w_keep = jk.sort_merge_dedup(
        jnp.asarray(sids), jnp.asarray(ts), jnp.asarray(seq),
        jnp.asarray(op_types), jnp.asarray(valid))
    assert order.numpy().dtype == np.asarray(w_order).dtype == np.int32
    np.testing.assert_array_equal(order.numpy(), np.asarray(w_order))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(w_keep))
    with pytest.raises(ValueError):
        tk.sort_merge_dedup(sids, ts.astype(np.int64) + 2**40, seq,
                            op_types, valid)
