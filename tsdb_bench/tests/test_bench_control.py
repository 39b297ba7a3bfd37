"""The control (the reference in bfloat16 in the program's place) fails
the limits that a run holds its answers to: at a small size on the CPU
here, and at each cell's own size on the card (`chip`)."""

import pytest

from tsdb_bench import control, run

from .conftest import load_bench

CELLS = ["tsbs-4000.dashboard", "tsbs-4000-4r.dashboard"]


def cell(root, name):
    return run.Cell(root, load_bench(root, kept_out=True), name)


@pytest.mark.parametrize("name", CELLS + ["tsbs-4000-4r.live"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_small(root, name, seed):
    c = cell(root, name)
    c.cfg = dict(c.cfg, hosts=40, hours=12)
    out = control.control_readings(c, seed, "cpu")
    assert out["control_fails"], out
    assert out["avg_err_over_bound"] > 3 * run.LIMITS["avg_err_over_bound"]


@pytest.mark.chip
@pytest.mark.parametrize("name", ["tsbs-4000.dashboard"])
def test_control_fails_at_the_cells_size(root, cuda_card, name):
    for seed in (101, 202, 303):
        out = control.control_readings(cell(root, name), seed, cuda_card)
        assert out["control_fails"], out
