"""The port's window-bounds counter against the JAX package's Pallas kernel.

`greptimedb_tpu_torch.ops.pallas_window.counts_leq` on a CPU tensor runs
its plain PyTorch version; `counts_leq_pallas(..., interpret=True)` runs
the TPU kernel in interpret mode. Both get the same numpy buckets and must
agree exactly. The Hopper kernel itself is held against the plain version
on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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
    before = tpw.counts_leq.launches
    tpw.counts_leq(torch.zeros((4, 8), dtype=torch.int32), 3)
    assert tpw.counts_leq.launches == before


def test_kernel_source_names_what_it_replaces():
    import os
    src = os.path.join(os.path.dirname(tpw.__file__), os.pardir, "csrc",
                       "counts_leq.cu")
    text = open(src).read()
    assert "greptimedb_tpu/ops/pallas_window.py" in text
    assert 'extern "C"' in text and "counts_leq_launch" in text
