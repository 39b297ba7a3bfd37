"""ops/window.py of the port against the JAX package's, on the same data.

The same numpy series (made from a seed) go through
greptimedb_tpu.ops.window (JAX on the CPU, x64 off as tests/conftest.py
sets it) and greptimedb_tpu_torch.ops.window (torch on the CPU, where the
window-bounds counter runs its plain version).

Tolerance: integers (bounds, counts) and ok masks must be equal. Floats
are compared where ok, within rtol 1e-5 plus an atol of
8 * eps32 * max|prefix| of the row: windowed sums are differences of
float32 prefix sums, which torch and XLA add in different orders, so the
error scales with the prefix's magnitude, not the window's. The prefix is
the running sum of |v| (of v*v for stdvar; the square root of that bound
for stddev, since |sqrt(a) - sqrt(b)| <= sqrt(|a - b|)).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greptimedb_tpu.ops import window as jw
from greptimedb_tpu_torch.ops import pallas_window as pw
from greptimedb_tpu_torch.ops import window as tw

# tiny tensors: one intra-op thread keeps parallel test workers off
# each other's cores
torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
BASE_MS = 1_700_000_000_000
SAMPLE_MS = 10_000


def _make_series(seed: int, S: int = 9, n: int = 120):
    """Per-series sample counts include an empty (all-pad) row, a row whose
    samples all lie before the query grid, counters with resets and a
    counter whose first sample is negative."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(n // 2, n, S)
    lens[0] = 0                                   # all-pad row
    sids, tss, vals = [], [], []
    for s, ln in enumerate(lens):
        slots = np.sort(rng.choice(np.arange(n * 2), size=ln, replace=False))
        ts = BASE_MS + slots * SAMPLE_MS + rng.integers(-3000, 3000, ln)
        ts = np.unique(ts)
        if s == 1:
            ts = ts - 10 * n * SAMPLE_MS          # outside every window
        if s % 3 == 2:                            # counter with resets
            v = np.cumsum(rng.random(len(ts)) * 4)
            for r in rng.integers(1, max(len(ts), 2), 2):
                v[r:] -= v[r] - rng.random()
            if s == 2:
                v = v - 5.0                       # negative first sample
        else:
            v = np.cumsum(rng.normal(0, 1, len(ts))) + rng.normal(0, 50)
        sids.append(np.full(len(ts), s))
        tss.append(ts)
        vals.append(v)
    sm = jw.SeriesMatrix.build(np.concatenate(sids), np.concatenate(tss),
                               np.concatenate(vals), S)
    rel, v, lg, base = sm.device_arrays()
    return rel, v.astype(np.float32), lg, base


@pytest.fixture(scope="module")
def data():
    return _make_series(7)


def _prefix_atol(v: np.ndarray, lengths: np.ndarray, op: str) -> np.ndarray:
    """[S, 1] atol: 8 * eps32 * max|prefix| per row (see module doc)."""
    valid = np.arange(v.shape[1])[None, :] < lengths[:, None]
    a = np.where(valid, np.abs(v.astype(np.float64)), 0.0)
    if op in ("stdvar_over_time", "stddev_over_time"):
        a = a * a
    tol = 8 * EPS32 * np.cumsum(a, axis=1).max(axis=1, initial=0.0)
    if op == "stddev_over_time":
        tol = np.sqrt(tol)
    return tol[:, None]


def _close(op, got, want, ok, v, lengths):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = np.broadcast_to(_prefix_atol(v, lengths, op), got.shape)
    with np.errstate(invalid="ignore"):
        bad = ok & ~(np.isclose(got, want, rtol=1e-5, atol=0.0) |
                     (np.abs(got - want) <= atol) |
                     (np.isnan(got) & np.isnan(want)))
    assert not bad.any(), (
        f"{op}: {bad.sum()} values differ, e.g. got {got[bad][:4]} "
        f"want {want[bad][:4]}")


def _pair(j, t):
    return (np.asarray(j[0]), np.asarray(j[1])), \
        (t[0].numpy(), t[1].numpy())


# (t0 relative to base, step, range, nsteps): step-aligned, non-aligned
# twice, a range wider than the grid, one step. The multi-step grids share
# nsteps so the reference compiles each op once for them.
GRIDS = [
    (300_000, 60_000, 300_000, 16),
    (317_000, 45_000, 300_000, 16),
    (300_000, 60_000, 330_000, 16),
    (0, 30_000, 1_200_000, 16),
    (900_000, 60_000, 300_000, 1),
]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[1]}s{g[2]}r{g[3]}")
def test_compute_window_bounds(data, grid):
    rel, v, lg, _ = data
    t0, step, rng_ms, T = grid
    jl, jh = jw.compute_window_bounds(jnp.asarray(rel), np.int32(t0),
                                      step=step, range_ms=rng_ms, nsteps=T)
    tl, th = tw.compute_window_bounds(torch.as_tensor(rel), t0, step=step,
                                      range_ms=rng_ms, nsteps=T)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    ends = t0 + np.arange(T) * step
    wl, wh = jw.window_bounds(jnp.asarray(rel),
                              jnp.asarray(ends.astype(np.int32)), rng_ms)
    pl_, ph_ = tw.window_bounds(torch.as_tensor(rel), ends, rng_ms)
    np.testing.assert_array_equal(pl_.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(ph_.numpy(), np.asarray(wh))


# nsteps == 1 for the cumsum family is covered by test_aligned_window_eval
@pytest.mark.parametrize("grid", [GRIDS[0], GRIDS[1]],
                         ids=lambda g: f"{g[1]}s{g[2]}r{g[3]}")
@pytest.mark.parametrize("op", sorted(jw.CUMSUM_OPS))
def test_range_aggregate_cumsum(data, op, grid):
    rel, v, lg, _ = data
    t0, step, rng_ms, T = grid
    (jv, jok), (tv, tok) = _pair(
        jw.range_aggregate_cumsum(jnp.asarray(rel), jnp.asarray(v),
                                  jnp.asarray(lg), np.int32(t0), step,
                                  rng_ms, op=op, nsteps=T),
        tw.range_aggregate_cumsum(torch.as_tensor(rel), torch.as_tensor(v),
                                  torch.as_tensor(lg), t0, step, rng_ms,
                                  op=op, nsteps=T))
    np.testing.assert_array_equal(tok, jok)
    assert tv.dtype == np.float32
    _close(op, tv, jv, jok, v, lg)


@pytest.mark.parametrize("op", ["rate", "sum_over_time", "resets"])
def test_range_aggregate_cumsum_host_int64_and_bounds(op):
    """Host int64 epoch timestamps are rebased like the reference's, and
    precomputed bounds give the same answer."""
    rng = np.random.default_rng(3)
    S, n = 4, 50
    ts = BASE_MS + np.cumsum(rng.integers(5_000, 15_000, (S, n)), axis=1)
    ts[3, 40:] = jw.TS_PAD
    lg = np.array([n, n, n, 40], np.int32)
    v = np.cumsum(rng.random((S, n)), axis=1).astype(np.float32)
    t0 = BASE_MS + 120_000
    jv, jok = jw.range_aggregate_cumsum(ts, jnp.asarray(v), jnp.asarray(lg),
                                        t0, 60_000, 120_000, op=op,
                                        nsteps=8)
    tv, tok = tw.range_aggregate_cumsum(ts, torch.as_tensor(v),
                                        torch.as_tensor(lg), t0, 60_000,
                                        120_000, op=op, nsteps=8)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    _close(op, tv.numpy(), np.asarray(jv), np.asarray(jok), v, lg)
    rel, t0r = tw._rebase_i64_host(ts, t0, 60_000, 8, 120_000)
    rel_t = torch.as_tensor(rel)
    b = tw.compute_window_bounds(rel_t, int(t0r), step=60_000,
                                 range_ms=120_000, nsteps=8)
    bv, bok = tw.range_aggregate_cumsum(rel_t, torch.as_tensor(v),
                                        torch.as_tensor(lg), t0r, 60_000,
                                        120_000, op=op, nsteps=8, bounds=b)
    np.testing.assert_array_equal(bok.numpy(), tok.numpy())
    np.testing.assert_array_equal(bv.numpy()[tok.numpy()],
                                  tv.numpy()[tok.numpy()])


def test_window_bounds_on_rows_longer_than_32768_samples():
    """The reference bins rows of up to 32768 samples and binary-searches
    longer ones; the port runs the window-bounds counter on every row
    length. Both must give the same bounds."""
    rng = np.random.default_rng(13)
    S, L = 3, 40_960
    rel = np.sort(rng.integers(0, 40 * 3_600_000, (S, L)), axis=1)
    rel = rel.astype(np.int32)
    rel[1, 35_000:] = np.iinfo(np.int32).max          # padded row
    t0, step, rng_ms, T = 1_800_000, 60_000, 300_000, 16
    jl, jh = jw.compute_window_bounds(jnp.asarray(rel), np.int32(t0),
                                      step=step, range_ms=rng_ms, nsteps=T)
    tl, th = tw.compute_window_bounds(torch.as_tensor(rel), t0, step=step,
                                      range_ms=rng_ms, nsteps=T)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert int(np.asarray(jh).max()) > 0
    ends = t0 + np.arange(T) * step
    wl, wh = jw.window_bounds(jnp.asarray(rel),
                              jnp.asarray(ends.astype(np.int32)), rng_ms)
    pl_, ph_ = tw.window_bounds(torch.as_tensor(rel), ends, rng_ms)
    np.testing.assert_array_equal(pl_.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(ph_.numpy(), np.asarray(wh))


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[1]}s{g[2]}r{g[3]}")
def test_counts_leq_grid_matches_reference(data, grid, monkeypatch):
    """The fused window-bounds entry on the extended grid (one range
    before t0, as the aligned path counts) equals the reference's
    _counts_leq_grid, and compute_window_bounds goes through it."""
    rel, _, _, _ = data
    t0, step, rng_ms, T = grid
    ext_t0, ext_T = t0 - rng_ms, T + rng_ms // step
    got = tw.counts_leq_grid(torch.as_tensor(rel), ext_t0, step, ext_T)
    want = jw._counts_leq_grid(jnp.asarray(rel), ext_t0, step, ext_T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    calls = []

    def spy(ts2d, t0_, step_, nsteps):
        calls.append((int(t0_), int(step_), int(nsteps)))
        return pw.counts_leq_grid(ts2d, t0_, step_, nsteps)

    monkeypatch.setattr(tw, "counts_leq_grid", spy)
    tw.compute_window_bounds(torch.as_tensor(rel), t0, step=step,
                             range_ms=rng_ms, nsteps=T)
    assert calls and all(c[1] == step for c in calls)
    assert tw.step_buckets is pw.step_buckets


def test_rebase_rejects_span_beyond_int32():
    ts = np.array([[BASE_MS, BASE_MS + 2**31 + 5]], np.int64)
    with pytest.raises(ValueError, match="exceeds int32"):
        tw._rebase_i64_host(ts, BASE_MS, 1000, 4, 0)


GATHER_PARAMS = {"quantile_over_time": (0.3, 0.0),
                 "predict_linear": (60.0, 0.0),
                 "holt_winters": (0.5, 0.3)}


@pytest.mark.parametrize("grid,with_bounds", [
    (GRIDS[0], False), (GRIDS[2], True), (GRIDS[4], False)],
    ids=["aligned", "unaligned-bounds", "one-step"])
@pytest.mark.parametrize("op", sorted(jw.GATHER_OPS))
def test_range_aggregate_gather(data, op, grid, with_bounds):
    rel, v, lg, _ = data
    t0, step, rng_ms, T = grid
    p1, p2 = GATHER_PARAMS.get(op, (0.0, 0.0))
    maxw = rel.shape[1]
    jb = tb = None
    if with_bounds:
        jb = jw.compute_window_bounds(jnp.asarray(rel), np.int32(t0),
                                      step=step, range_ms=rng_ms, nsteps=T)
        tb = tw.compute_window_bounds(torch.as_tensor(rel), t0, step=step,
                                      range_ms=rng_ms, nsteps=T)
    (jv, jok), (tv, tok) = _pair(
        jw.range_aggregate_gather(jnp.asarray(rel), jnp.asarray(v),
                                  np.int32(t0), step, rng_ms, op=op,
                                  nsteps=T, maxw=maxw, param=p1, param2=p2,
                                  series_block=4, bounds=jb),
        tw.range_aggregate_gather(torch.as_tensor(rel), torch.as_tensor(v),
                                  t0, step, rng_ms, op=op, nsteps=T,
                                  maxw=maxw, param=p1, param2=p2,
                                  series_block=4, bounds=tb))
    np.testing.assert_array_equal(tok, jok)
    _close(op, tv, jv, jok, v, lg)


def test_gather_window_truncated_to_maxw(data):
    """Windows longer than maxw keep their most recent maxw samples."""
    rel, v, lg, _ = data
    (jv, jok), (tv, tok) = _pair(
        jw.range_aggregate_gather(jnp.asarray(rel), jnp.asarray(v),
                                  np.int32(300_000), 60_000, 600_000,
                                  op="max_over_time", nsteps=16, maxw=3),
        tw.range_aggregate_gather(torch.as_tensor(rel), torch.as_tensor(v),
                                  300_000, 60_000, 600_000,
                                  op="max_over_time", nsteps=16, maxw=3))
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tv[tok], jv[jok])


@pytest.mark.parametrize("grid", [GRIDS[0], GRIDS[4]],
                         ids=lambda g: f"{g[1]}s{g[2]}r{g[3]}")
def test_aligned_window_eval(data, grid):
    rel, v, lg, _ = data
    t0, step, rng_ms, T = grid
    ja = jw.AlignedWindowEval(jnp.asarray(rel), jnp.asarray(v),
                              jnp.asarray(lg), np.int32(t0), step, rng_ms, T)
    ta = tw.AlignedWindowEval(torch.as_tensor(rel), torch.as_tensor(v),
                              torch.as_tensor(lg), t0, step, rng_ms, T)
    np.testing.assert_array_equal(ta.ext().numpy(), np.asarray(ja.ext()))
    for op in sorted(jw.CUMSUM_OPS):
        (jv, jok), (tv, tok) = _pair(ja.eval(op), ta.eval(op))
        np.testing.assert_array_equal(tok, jok, err_msg=op)
        _close(op, tv, jv, jok, v, lg)
    with pytest.raises(ValueError):
        tw.AlignedWindowEval(torch.as_tensor(rel), torch.as_tensor(v),
                             torch.as_tensor(lg), t0, 60_000, 90_000, T)


@pytest.mark.parametrize("grid", [(0, 60_000, 300_000, 32),
                                  (455_000, 15_000, 60_000, 16),
                                  (900_000, 60_000, 300_000, 1)],
                         ids=lambda g: f"{g[1]}s{g[2]}lb{g[3]}")
def test_instant_select(data, grid):
    rel, v, lg, _ = data
    t0, step, lookback, T = grid
    (jv, jok), (tv, tok) = _pair(
        jw.instant_select(jnp.asarray(rel), jnp.asarray(v), np.int32(t0),
                          step, lookback, nsteps=T),
        tw.instant_select(torch.as_tensor(rel), torch.as_tensor(v), t0,
                          step, lookback, nsteps=T))
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tv[tok], jv[jok])


def test_series_matrix_build_matches():
    rng = np.random.default_rng(11)
    sids = np.sort(rng.integers(-1, 6, 80))
    ts = np.concatenate([np.sort(rng.integers(0, 10**6, (sids == s).sum()))
                         for s in np.unique(sids)]) + BASE_MS
    vals = rng.random(80)
    a = jw.SeriesMatrix.build(sids, ts, vals, 5)
    b = tw.SeriesMatrix.build(sids, ts, vals, 5)
    for x, y in zip(a.device_arrays(), b.device_arrays()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert (a.num_series, a.max_len) == (b.num_series, b.max_len)
