"""The port's window-bounds counter against the JAX package's Pallas kernel.

`greptimedb_tpu_torch.ops.pallas_window.counts_leq` on a CPU tensor runs
its plain PyTorch version; `counts_leq_pallas(..., interpret=True)` runs
the TPU kernel in interpret mode. Both get the same numpy buckets and must
agree exactly. `counts_leq_grid`, the entry that buckets timestamps in the
kernel's loads, must equal the reference's `_counts_leq_grid` (eager JAX)
and `counts_leq_pallas` of the reference's buckets, exactly. The Hopper
kernel itself is held against the plain versions on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greptimedb_tpu.ops import window as jw
from greptimedb_tpu.ops.pallas_window import counts_leq_pallas
from greptimedb_tpu_torch.ops import pallas_window as tpw

# tiny tensors: one intra-op thread keeps parallel test workers off
# each other's cores
torch.set_num_threads(1)


def _both(b: np.ndarray, steps: int):
    want = np.asarray(counts_leq_pallas(jnp.asarray(b), steps,
                                        interpret=True))
    got = tpw.counts_leq(torch.as_tensor(b), steps)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    return got.numpy(), want


@pytest.mark.parametrize("shape,steps,sort", [
    ((8, 512), 128, True),        # tests/test_pallas.py's cases
    ((20, 300), 97, True),
    ((1, 1), 1, True),
    ((130, 1030), 200, True),
    ((20, 300), 97, False),       # unsorted rows
    ((33, 257), 64, False),
    ((5, 40), 1, False),          # nsteps == 1
])
def test_counts_leq_matches_pallas(shape, steps, sort):
    rng = np.random.default_rng(sum(shape) * 1000 + steps)
    b = rng.integers(0, steps + 1, shape).astype(np.int32)
    if sort:
        b = np.sort(b, axis=1)
    got, want = _both(b, steps)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, (b[:, :, None] <= np.arange(steps)).sum(1))


def test_out_of_range_buckets_excluded():
    b = np.array([[0, 2, 5, 5, 5]], np.int32)   # 5 == nsteps → no step
    got, want = _both(b, 5)
    assert got[0].tolist() == want[0].tolist() == [1, 1, 2, 2, 2]


def test_all_pad_and_negative_buckets():
    """Rows of pads count nowhere; buckets below 0 or above nsteps
    compute the same function as the compare-reduce."""
    b = np.array([[7, 7, 7, 7], [-3, 0, 9, 2], [7, 1, 7, 0]], np.int32)
    got, want = _both(b, 7)
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == [0] * 7


@pytest.mark.parametrize("shape,steps", [((0, 16), 4), ((3, 0), 4),
                                         ((3, 16), 0)])
def test_degenerate_shapes(shape, steps):
    b = np.zeros(shape, np.int32)
    got = tpw.counts_leq(torch.as_tensor(b), steps).numpy()
    assert got.shape == (shape[0], steps)
    np.testing.assert_array_equal(
        got, (b[:, :, None] <= np.arange(steps)).sum(1).reshape(got.shape))


def test_cpu_path_launches_no_kernel():
    before = tpw.counts_leq.launches, tpw.counts_leq_grid.launches
    tpw.counts_leq(torch.zeros((4, 8), dtype=torch.int32), 3)
    tpw.counts_leq_grid(torch.zeros((4, 8), dtype=torch.int32), 0, 5, 3)
    assert (tpw.counts_leq.launches, tpw.counts_leq_grid.launches) == before


PAD32 = np.iinfo(np.int32).max


def _ref_buckets(ts: np.ndarray, t0: int, step: int, nsteps: int):
    """The reference's bucketing (greptimedb_tpu/ops/window.py:
    _counts_leq_grid) in numpy: clip(-floor_divide(t0 - ts, step), 0,
    nsteps), pads routed through t0 and forced to nsteps."""
    is_pad = ts == PAD32
    safe = np.where(is_pad, t0, ts.astype(np.int64))
    b = np.clip(-np.floor_divide(t0 - safe, step), 0, nsteps)
    return np.where(is_pad, nsteps, b).astype(np.int32)


def _grid_case(kind: str, shape, nsteps: int, rng):
    """(ts, t0, step) for one bucketing edge case; every difference the
    reference takes stays inside int32 (it computes with x64 off)."""
    if kind == "random":              # rows in no order, 10 % pads
        ts = rng.integers(-3000, (nsteps + 3) * 1000, shape)
        ts[rng.random(shape) < 0.1] = PAD32
        return ts, 0, 1000
    if kind == "on-grid":             # ts = t0 + k*step, q = 0 at k = 0
        return 7000 + 1000 * rng.integers(-3, nsteps + 3, shape), 7000, 1000
    if kind == "q=0":
        return np.full(shape, 123_456), 123_456, 60_000
    if kind == "far-below":           # ts far below a negative t0, and above
        return rng.integers(-2**30, 2**30, shape), -5_000_000, 60_000
    if kind == "step=1":
        return rng.integers(90, nsteps + 110, shape), 100, 1
    if kind == "wide-step":           # one step spans every sample
        return rng.integers(0, 10**6, shape), 0, 10**9
    if kind == "mid-pads":            # sorted rows, pads between samples
        ts = np.sort(rng.integers(0, nsteps * 1000, shape), axis=1)
        ts[rng.random(shape) < 0.2] = PAD32
        ts[0] = PAD32                 # and one row of pads only
        return ts, 0, 1000
    raise ValueError(kind)


# shapes and nsteps of the cases above, so the reference's compiled
# programs are shared
@pytest.mark.parametrize("shape,steps,kind", [
    ((8, 512), 128, "random"),
    ((20, 300), 97, "on-grid"),
    ((20, 300), 97, "q=0"),
    ((33, 257), 64, "far-below"),
    ((8, 512), 128, "step=1"),
    ((5, 40), 1, "wide-step"),
    ((130, 1030), 200, "wide-step"),
    ((33, 257), 64, "mid-pads"),
    ((1, 1), 1, "random"),
])
def test_counts_leq_grid_matches_reference(shape, steps, kind):
    rng = np.random.default_rng(sum(shape) * 1000 + steps)
    ts, t0, step = _grid_case(kind, shape, steps, rng)
    ts = ts.astype(np.int32)
    got = tpw.counts_leq_grid(torch.as_tensor(ts), t0, step, steps)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    got = got.numpy()
    want = np.asarray(jw._counts_leq_grid(jnp.asarray(ts), t0, step, steps))
    np.testing.assert_array_equal(got, want)
    b = _ref_buckets(ts, t0, step, steps)
    np.testing.assert_array_equal(
        got, np.asarray(counts_leq_pallas(jnp.asarray(b), steps,
                                          interpret=True)))
    np.testing.assert_array_equal(
        tpw.step_buckets(torch.as_tensor(ts), t0, step, steps).numpy(), b)


@pytest.mark.parametrize("call,match", [
    (lambda: tpw.counts_leq(torch.zeros(8, dtype=torch.int32), 3), "2-d"),
    (lambda: tpw.counts_leq(torch.zeros((2, 8), dtype=torch.int32), -1),
     "negative"),
    (lambda: tpw.counts_leq_grid(torch.zeros(8, dtype=torch.int32), 0, 1, 3),
     "2-d"),
    (lambda: tpw.counts_leq_grid(torch.zeros((2, 8), dtype=torch.int64), 0,
                                 1, 3), "int32"),
    (lambda: tpw.counts_leq_grid(torch.zeros((2, 8)), 0, 1, 3), "int32"),
    (lambda: tpw.counts_leq_grid(torch.zeros((2, 8), dtype=torch.int32), 0,
                                 1, -1), "negative"),
    (lambda: tpw.counts_leq_grid(torch.zeros((2, 8), dtype=torch.int32), 0,
                                 0, 3), "step"),
    (lambda: tpw.counts_leq_grid(torch.zeros((2, 8), dtype=torch.int32), 0,
                                 -60_000, 3), "step"),
    (lambda: tpw.counts_leq_grid(torch.zeros((2, 8), dtype=torch.int32), 0,
                                 2**62 + 1, 3), "step"),
    (lambda: tpw.counts_leq_grid(torch.zeros((2, 8), dtype=torch.int32),
                                 -2**62 - 1, 1, 3), "t0"),
    (lambda: tpw.counts_leq_grid(torch.zeros((2, 3), dtype=torch.int32,
                                             device="meta"), 0, 1, 4),
     "no kernel"),
], ids=["leq-rank", "leq-nsteps", "grid-rank", "grid-int64", "grid-float",
        "grid-nsteps", "grid-step-0", "grid-step-negative", "grid-step-huge",
        "grid-t0-huge", "grid-meta-device"])
def test_wrapper_argument_checks(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_kernel_source_names_what_it_replaces():
    import os
    src = os.path.join(os.path.dirname(tpw.__file__), os.pardir, "csrc",
                       "counts_leq.cu")
    text = open(src).read()
    assert "greptimedb_tpu/ops/pallas_window.py" in text
    assert 'extern "C"' in text and "counts_leq_launch" in text
    assert "counts_leq_grid_launch" in text


def test_division_variants_each_change_the_source():
    """tools/k1_division.py times variants made by replacing one line of
    the kernel source; each replacement must still find its line."""
    import os
    from greptimedb_tpu_torch.tools import k1_division
    src = os.path.join(os.path.dirname(tpw.__file__), os.pardir, "csrc",
                       "counts_leq.cu")
    text = open(src).read()
    variants = k1_division._variants(text)
    assert variants["multiply-shift (committed)"] == text
    for name in ("64-bit division forced", "plain 32-bit division"):
        changed = [a for a, b in zip(text.splitlines(),
                                     variants[name].splitlines()) if a != b]
        assert len(changed) == 1, name
