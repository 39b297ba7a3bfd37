"""The segment-moments timing tool (greptimedb_tpu_torch/tools/
segment_moments_bench.py) on the CPU, torch only: its main-path input
functions at a reduced scale (16 hosts x 2 h), the shared byte bound
against a hand count, the library yardstick's calls, and its edge cases
through the wrapper, which runs the plain version for CPU tensors.
Exact comparisons throughout: nothing here rounds differently."""

import numpy as np
import pytest
import torch

from greptimedb_tpu_torch.ops import cuda_build
from greptimedb_tpu_torch.ops import kernels as K
from greptimedb_tpu_torch.tools import segment_moments_bench as smb

HOSTS, HOURS = 16, 2
PER_HOST = HOURS * smb.PER_HOUR
N = HOSTS * PER_HOST
#: the edge cases small enough for the plain version on the CPU
SMALL = [name for name, _ in smb.edge_cases() if " M " not in name]


def _inputs(q):
    return smb.main_path_inputs(q, "cpu", hosts=HOSTS, hours=HOURS, seed=3)


@pytest.mark.parametrize("q, runs, length, live_rows, live_runs, ops", [
    ("Q1", HOSTS * HOURS, 360, N, HOSTS * HOURS, ["sum", "count"] * 10),
    ("Q4", N // 6, 6, 8 * 360, 8 * 60, ["max", "count"] * 5),
    ("Q6", 1, N, N, 1, ["max", "count", "sum", "count", "min", "first",
                        "max", "last"]),
])
def test_main_path_inputs(q, runs, length, live_rows, live_runs, ops):
    sig = smb.signature(_inputs(q))
    assert sig["rows"] == N
    assert sig["runs"] == runs
    assert sig["run_lengths"] == {length: runs}
    assert sig["live_rows"] == live_rows
    assert sig["live_runs"] == live_runs
    assert sig["ops"] == ops
    assert all(sig["column_masks_all_set"])


def test_main_path_inputs_share_storage_as_the_sql_path_does():
    """Q1: a fresh row mask, each field read by its sum and its count,
    one all-valid column mask; Q6: that mask is also the row mask, and
    first/last's min/max ts moments read ts itself."""
    s1 = smb.signature(_inputs("Q1"))["storage"]
    assert s1[:2] == [0, 1]
    assert s1[2:22] == [2 + i // 2 for i in range(20)]
    assert set(s1[22:]) == {12}
    s6 = smb.signature(_inputs("Q6"))["storage"]
    assert s6 == [0, 1, 2, 2, 3, 3, 1, 4, 1, 4] + [0] * 8
    assert smb.signature(_inputs("Q4"))["value_types"] == \
        ["torch.float32"] * 10


def test_q4_live_rows_are_the_first_hour_of_eight_hosts():
    mask = _inputs("Q4")[1].view(HOSTS, PER_HOST)
    hosts = mask.any(dim=1)
    assert int(hosts.sum()) == 8
    assert bool(mask[hosts, :smb.PER_HOUR].all())
    assert not bool(mask[:, smb.PER_HOUR:].any())


def test_moments_bound_q4_by_hand():
    """Row mask and ends in full, the five fields and the column mask at
    the live share (no ts: no first/last), seven int32 outputs: the five
    maxima, one count (the five counts over one column mask merge) and
    the row counts."""
    ms, by, nbytes = smb.moments_bound(_inputs("Q4"))
    G, live = N // 6, 8 * 360 / N
    want = G * 4 + N + live * (5 * 4 * N + N) + 7 * G * 4
    assert nbytes == pytest.approx(want, rel=1e-12)
    assert by == "bytes"
    assert ms == pytest.approx(want / 3.35e12 * 1e3, rel=1e-12)


def test_moments_bound_q1_by_hand():
    """Every row live: ends, row mask, ten fields and one column mask in
    full; ten sums, one merged count and the row counts written."""
    _, by, nbytes = smb.moments_bound(_inputs("Q1"))
    G = HOSTS * HOURS
    assert nbytes == pytest.approx(G * 4 + N + 10 * 4 * N + N + 12 * G * 4,
                                   rel=1e-12)
    assert by == "bytes"


def test_moments_bound_small_case_by_hand():
    """24 rows in 4 runs of 6, the first run live; two float32 columns
    (max and count each) over one all-valid column mask."""
    ends = torch.tensor([6, 12, 18, 24], dtype=torch.int32)
    mask = torch.zeros(24, dtype=torch.bool)
    mask[:6] = True
    ts = torch.zeros(24, dtype=torch.int32)
    a, b = torch.rand(24), torch.rand(24)
    valid = torch.ones(24, dtype=torch.bool)
    args = (ends, mask, ts, [a, a, b, b], [valid] * 4,
            ["max", "count", "max", "count"])
    _, by, nbytes = smb.moments_bound(args)
    # ends 16 + mask 24 + 1/4 x (96 + 96 + 24) + 4 outputs (two maxima,
    # one merged count, the row counts) x 16
    assert nbytes == pytest.approx(16 + 24 + 54 + 64, rel=1e-12)
    assert by == "bytes"


def test_moments_bound_counts_ts_for_first_last():
    """Q6, every row live: mask (also the column mask), ends, user,
    system and ts (min/max read it as a column, first/last as the order)
    in full; idle only at the row first and last choose; eight outputs
    (the two counts merge, plus the row counts) of one run."""
    _, _, with_ts = smb.moments_bound(_inputs("Q6"))
    assert with_ts == pytest.approx(N + 4 + 3 * 4 * N + 2 * 4 + 8 * 4,
                                    rel=1e-12)


@pytest.mark.parametrize("q, calls", [("Q1", 21), ("Q4", 11), ("Q6", 7)])
def test_library_moments_calls(q, calls):
    args = _inputs(q)
    run, n = smb.library_moments(args)
    assert n == calls
    run()


@pytest.mark.parametrize("q", smb.QUERIES)
def test_plain_version_on_the_main_path_inputs(q):
    ends, mask, ts, vals, cms, ops = args = _inputs(q)
    res, counts = K.segment_moments(*args)
    G = ends.shape[0]
    assert counts.shape == (G,) and all(r.shape == (G,) for r in res)
    assert int(counts.sum()) == int(mask.sum())
    if q == "Q1":
        assert bool((counts == 360).all())
        torch.testing.assert_close(
            res[0], vals[0].double().view(G, 360).sum(1).float(),
            rtol=0, atol=0)
    elif q == "Q4":
        live = counts > 0
        assert int(live.sum()) == 480
        assert bool((res[0][~live] == float("-inf")).all())
    else:
        idle = vals[5]
        # ts ties across hosts break by row: the first host's first row,
        # the last host's last row
        assert res[5].item() == idle[0].item()
        assert res[7].item() == idle[-1].item()
        assert res[4].item() == 0 and res[6].item() == int(ts.max())


@pytest.mark.parametrize("name", SMALL)
def test_edge_cases_through_the_wrapper(name):
    build = dict(smb.edge_cases())[name]
    args = build("cpu")
    assert smb.moments_agree(name, args, quiet=True) == 0.0


def test_edge_cases_cover_the_design_edges():
    cases = dict(smb.edge_cases())
    off = cases["columns and masks 4 bytes into their allocations (not "
                "16-byte aligned)"]("cpu")
    _, mask, ts, vals, cms, _ = off
    for t in [mask, ts, vals[0], vals[7], cms[0]]:
        assert t.data_ptr() % 16 == 4
    ends, mask, *_ = cases["dead tiles beside live ones, runs crossing "
                           "between them"]("cpu")
    tiles = torch.nn.functional.pad(
        mask, (0, -mask.shape[0] % smb.KTILE)).view(-1, smb.KTILE).any(1)
    dead = (~tiles).nonzero().flatten().tolist()
    assert dead == [1, 2, 5, 6, 7, 11]
    e = ends.numpy().astype(np.int64)
    s = np.concatenate([[0], e[:-1]])
    assert ((s // smb.KTILE < 5) & ((e - 1) // smb.KTILE > 7)).any()
    ends = cases[f"runs ending on {smb.KTILE}-row tile edges, runs of "
                 f"{smb.KSHORT + 1} rows"]("cpu")[0].numpy()
    lens = np.diff(ends, prepend=0)
    assert (ends % smb.KTILE == 0).sum() >= 5
    assert (lens == smb.KSHORT + 1).sum() >= 4
    many = cases["33 moments (two launches)"]("cpu")
    assert len({c.data_ptr() for c in many[4]}) == 33
    assert cases["0 moments (row counts only)"]("cpu")[5] == []
    for k in (10, 11):
        cms = cases[f"{k} distinct column masks ({k + 1} mask tiles in "
                    f"shared memory)"]("cpu")[4]
        assert len({c.data_ptr() for c in cms}) == k


def test_kernel_swap_restores_the_loaded_library():
    before = cuda_build._libs.get("segment_moments")
    stand_in = object()
    with smb._kernel_from(stand_in):
        assert cuda_build._libs["segment_moments"] is stand_in
    assert cuda_build._libs.get("segment_moments") is before
