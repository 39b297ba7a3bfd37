"""The port's parallel/ over gloo ranks against the JAX package's parallel/
over a virtual device mesh of the same shape.

Every case's numpy inputs (made from a seed) go through
greptimedb_tpu.parallel on `make_mesh(jax.devices()[:n])` (conftest's 8
virtual CPU devices) and through greptimedb_tpu_torch.parallel on n
spawned gloo ranks (parallel/launch.py), for n in 1, 2, 4 and 8. Each
world size is spawned once per module, all four at once, and runs every
case in one rank function (`launch.run_calls`); the reference compiles
one program per op tuple and mesh.

Tolerance: counts, min, max, first, last, ok masks, errors and every
output dtype must be equal. Float sums (sum, avg, stddev, variance, the
cumsum-path range functions, the windowed sums) agree within rtol 3e-4
and atol 1e-4, the reference's own bound (__graft_entry__.py).
"""

import threading

import numpy as np
import pytest
import torch

import jax

from greptimedb_tpu.ops import window as jw
from greptimedb_tpu import parallel as jp
from greptimedb_tpu_torch import parallel as tp
from greptimedb_tpu_torch.parallel import launch
from greptimedb_tpu_torch.tools import multichip

torch.set_num_threads(1)

RTOL, ATOL = 3e-4, 1e-4
WORLDS = (1, 2, 4, 8)
EXACT = ("count", "min", "max", "first", "last", "min_over_time",
         "max_over_time")
AGG_GROUPS = {"sums": ("sum", "count", "avg", "min", "max"),
              "moments": ("stddev", "variance"),
              "picks": ("first", "last")}
CASES = ([f"agg_{g}" for g in AGG_GROUPS] +
         ["agg_col_masks_padding", "agg_int_exact", "agg_few_rows",
          "series_avg_over_time", "series_rate", "series_max_over_time",
          "series_rebase_padding", "blocked_sum", "blocked_avg",
          "blocked_min", "blocked_max", "blocked_steps_not_divisible",
          "blocked_window_too_wide"])


def _rows(rng, n, groups):
    gids = rng.integers(0, groups, n).astype(np.int32)
    mask = rng.random(n) > 0.1
    ts = rng.integers(0, 1_000_000, n).astype(np.int64)
    vals = rng.normal(size=n).astype(np.float32)
    return gids, mask, ts, vals


def _cases():
    """name -> (API function name, args, kwargs), the same for both
    packages (the mesh goes in by keyword)."""
    rng = np.random.default_rng(7)
    out = {}
    gids, mask, ts, vals = _rows(rng, 10_000, 37)
    for g, ops in AGG_GROUPS.items():
        out[f"agg_{g}"] = ("distributed_grouped_aggregate",
                           (gids, mask, ts, tuple(vals for _ in ops)),
                           {"num_groups": 37, "ops": ops})
    # 1003 rows: padding on every mesh but (1, 1); column masks
    gids, mask, ts, vals = _rows(rng, 1003, 5)
    ops = ("sum", "count", "avg", "min", "max", "first", "last", "stddev")
    cols = tuple(rng.normal(size=1003).astype(np.float32) for _ in ops)
    cms = tuple(rng.random(1003) > 0.4 for _ in ops)
    out["agg_col_masks_padding"] = (
        "distributed_grouped_aggregate", (gids, mask, ts, cols, cms),
        {"num_groups": 5, "ops": ops})
    # int values above 2**24 (not float32-exact) and sums that wrap
    n = 257
    gids = rng.integers(0, 3, n).astype(np.int32)
    ts = np.arange(n).astype(np.int32)
    ivals = (rng.integers(2**26, 2**28, n).astype(np.int64) * 4 + 1)
    ops = ("first", "last", "sum", "min", "max")
    out["agg_int_exact"] = ("distributed_grouped_aggregate",
                            (gids, np.ones(n, bool), ts, (ivals,) * 5),
                            {"num_groups": 3, "ops": ops})
    # fewer rows than ranks: whole shards of padding
    gids, mask, ts, vals = _rows(rng, 5, 4)
    ops = ("sum", "count", "min", "last")
    out["agg_few_rows"] = ("distributed_grouped_aggregate",
                           (gids, mask, ts, (vals,) * 4),
                           {"num_groups": 4, "ops": ops})
    # 13 series: padding on every mesh of 2 or more
    S, per = 13, 50
    sids = np.repeat(np.arange(S), per).astype(np.int32)
    sts = np.tile(np.arange(per) * 10_000, S).astype(np.int64) + 5
    svals = rng.normal(size=S * per).astype(np.float32).cumsum().astype(
        np.float32)
    m = jw.SeriesMatrix.build(sids, sts, svals, S)
    for op in ("avg_over_time", "rate", "max_over_time"):
        out[f"series_{op}"] = ("series_sharded_range_aggregate",
                               (m.ts, m.values, m.lengths, 60_000, 30_000,
                                60_000), {"op": op, "nsteps": 12})
    # epoch-ms int64 timestamps: the rebase to int32 plus series padding
    per = 16
    sids = np.repeat(np.arange(S), per).astype(np.int32)
    base = 1_700_000_000_000
    ets = (np.tile(np.arange(per) * 10_000, S) + base).astype(np.int64)
    m = jw.SeriesMatrix.build(sids, ets, rng.random(S * per).astype(
        np.float32), S)
    out["series_rebase_padding"] = (
        "series_sharded_range_aggregate",
        (m.ts, m.values, m.lengths, base + 60_000, 30_000, 60_000),
        {"op": "sum_over_time", "nsteps": 4})
    grid = rng.normal(size=(5, 64)).astype(np.float32)
    for op in ("sum", "avg", "min", "max"):
        out[f"blocked_{op}"] = ("time_blocked_window_sum", (grid,),
                                {"window": 7, "op": op})
    out["blocked_steps_not_divisible"] = (
        "time_blocked_window_sum", (np.zeros((2, 30), np.float32),),
        {"window": 3})
    out["blocked_window_too_wide"] = (
        "time_blocked_window_sum", (np.zeros((2, 64), np.float32),),
        {"window": 10})
    assert list(out) == CASES
    return out


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def ranks(cases):
    """n -> (the mesh layout rank 0 saw, each case's result), one spawn of
    each world size, the four at once."""
    calls = [("mesh_layout", (), {})] + list(cases.values())
    got, errors = {}, []

    def run(n):
        try:
            got[n] = launch.run_ranks(n, launch.run_calls, calls,
                                      device="cpu")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append((n, e))

    threads = [threading.Thread(target=run, args=(n,)) for n in WORLDS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0][1]
    return {n: (r[0], dict(zip(cases, r[1:]))) for n, r in got.items()}


def _reference(case, n):
    name, args, kwargs = case
    try:
        return getattr(jp, name)(*args, mesh=jp.make_mesh(
            jax.devices()[:n]), **kwargs)
    except ValueError as e:
        return ("error", type(e).__name__, str(e))


def _is_error(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and \
        isinstance(x[0], str) and x[0] == "error"


def _same_array(label, g, w, exact):
    g, w = np.asarray(g), np.asarray(w)
    assert g.dtype == w.dtype, (label, g.dtype, w.dtype)
    assert g.shape == w.shape, (label, g.shape, w.shape)
    if exact or not np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_equal(g, w, err_msg=label)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=label)


@pytest.mark.parametrize("n", WORLDS)
def test_mesh_layout(ranks, n):
    layout, _ = ranks[n]
    ref = jp.make_mesh(jax.devices()[:n])
    assert layout["shape"] == dict(ref.shape)
    assert layout["size"] == ref.size == n
    assert tuple(layout["axis_names"]) == ref.axis_names == tp.ROW_AXES
    assert layout["rank"] == 0 and layout["coords"] == [0, 0]
    assert layout["device"] == "cpu"
    # a rank imports the port and not the JAX package
    assert not {"jax", "jaxlib", "greptimedb_tpu"} & set(layout["packages"])
    assert "greptimedb_tpu_torch" in layout["packages"]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_matches_reference_mesh(ranks, cases, case, n):
    got = ranks[n][1][case]
    want = _reference(cases[case], n)
    if _is_error(want):
        assert tuple(got) == want
        return
    assert not _is_error(got), got
    name, _, kwargs = cases[case]
    if name == "distributed_grouped_aggregate":
        (g_res, g_counts), (w_res, w_counts) = got, want
        _same_array("counts", g_counts, w_counts, True)
        for op, g, w in zip(kwargs["ops"], g_res, w_res):
            _same_array(op, g, w, op in EXACT)
    elif name == "series_sharded_range_aggregate":
        (g_out, g_ok), (w_out, w_ok) = got, want
        _same_array("ok", g_ok, w_ok, True)
        w_ok = np.asarray(w_ok)
        _same_array(kwargs["op"], g_out[w_ok], np.asarray(w_out)[w_ok],
                    kwargs["op"] in EXACT)
    else:
        _same_array(kwargs["op"] if "op" in kwargs else "sum", got, want,
                    kwargs.get("op") in EXACT)


def test_single_process_mesh():
    """Without a process group the mesh is (1, 1) on the same code path;
    the axis sizes are checked as the reference checks them."""
    mesh = tp.make_mesh(device="cpu")
    ref = jp.make_mesh(jax.devices()[:1])
    assert mesh.shape == dict(ref.shape) and mesh.size == 1
    assert mesh.axis_names == ref.axis_names
    for kw in ({"region": 2}, {"block": 3}, {"region": 1, "block": 2}):
        with pytest.raises(ValueError):
            jp.make_mesh(jax.devices()[:1], **kw)
        with pytest.raises(ValueError):
            tp.make_mesh(device="cpu", **kw)
    for n, k in ((0, 8), (7, 1), (9, 8), (16, 8), (1003, 4)):
        assert tp.pad_rows_to_multiple(n, k) == jp.pad_rows_to_multiple(n, k)
    got, counts = tp.distributed_grouped_aggregate(
        np.array([0, 1, 1], np.int32), np.ones(3, bool),
        np.arange(3, dtype=np.int32), (np.ones(3, np.float32),),
        num_groups=2, ops=("sum",), mesh=mesh)
    assert counts.tolist() == [1, 2] and got[0].tolist() == [1.0, 2.0]


def test_dryrun_multichip_on_two_gloo_ranks():
    """tools/multichip.py's four checks over two spawned gloo ranks, and
    its one-device query step."""
    fn, args = multichip.entry("cpu")
    avg_cpu, max_mem, cnt, counts = fn(*args)
    assert int(counts.sum()) == 4096 and counts.dtype == torch.int32
    info = multichip.dryrun_multichip(2, device="cpu")
    assert info["shape"] == {"region": 1, "block": 2}
    assert info["distributed_query_rows"] == 12
