"""Whole runs at a small size on the CPU, the look for a card skipped:
sound, they come out correct; with the timed path broken underneath,
`correct` comes out false, once for each fault that the cells can have.

- half of each group's rows left out, the aggregate taken over the rest
  (the scan's validity masks drop every other row);
- an answer altered where it is produced (`_finalize`'s first value);
- the fold across regions left out (one region's frame dropped);
- the writer's state left unchanged (row inserts acknowledged, not
  written), in the live mix kept out of BENCHMARK.json.

The live cell's sound run is not here: the program's memtable snapshot
race (PERF.md, Open questions) can fail it.
"""

import pytest

from tsdb_bench import run

from .conftest import load_bench

SECONDS = 4.0


@pytest.fixture
def small_run(root, monkeypatch):
    from greptimedb_tpu_torch.query import tpu_exec
    monkeypatch.setattr(tpu_exec, "_dispatch_min_rows", lambda: 0)
    bench = load_bench(root, kept_out=True)

    def go(name, prepare=None, seed=21):
        cell = run.Cell(root, bench, name)
        cell.cfg = dict(cell.cfg, hosts=24, hours=12)
        return run.run_cell(root, cell, seed, SECONDS, trace=False,
                            device="cpu", prepare=prepare)
    return go


def half_rows(monkeypatch):
    import torch
    from greptimedb_tpu_torch.query import tpu_exec
    orig = tpu_exec.MergedScan.device_valid

    def valid(self, name):
        v = orig(self, name)
        keep = torch.arange(v.shape[0], device=v.device) % 2 == 0
        return v & keep
    return lambda fe: monkeypatch.setattr(tpu_exec.MergedScan,
                                          "device_valid", valid)


def altered_answer(monkeypatch):
    from greptimedb_tpu_torch.query import ir
    orig = ir._finalize

    def finalize(merged, plan):
        out = orig(merged, plan)
        col = out.columns[-1]
        out[col] = out[col].astype("float64")
        out.loc[out.index[0], col] = out[col].iloc[0] * (1 + 1e-4) + 1e-6
        return out
    return lambda fe: monkeypatch.setattr(ir, "_finalize", finalize)


def fold_left_out(monkeypatch):
    from greptimedb_tpu_torch.query import ir
    orig = ir.region_moment_frames

    def frames(table, plan, device, *a, **k):
        out = orig(table, plan, device, *a, **k)
        return out[:-1] if len(out) > 1 else out
    return lambda fe: monkeypatch.setattr(ir, "region_moment_frames", frames)


def writes_dropped(monkeypatch):
    def prepare(fe):
        def insert(table_name, columns, **kw):
            return len(next(iter(columns.values())))
        monkeypatch.setattr(fe, "handle_row_insert", insert)
    return prepare


@pytest.mark.parametrize("name", ["tsbs-4000.dashboard",
                                  "tsbs-4000-4r.dashboard"])
def test_sound_runs_are_correct(small_run, name):
    out = small_run(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name,fault", [
    ("tsbs-4000.dashboard", half_rows),
    ("tsbs-4000.dashboard", altered_answer),
    ("tsbs-4000-4r.dashboard", half_rows),
    ("tsbs-4000-4r.dashboard", altered_answer),
    ("tsbs-4000-4r.dashboard", fold_left_out),
    ("tsbs-4000-4r.live", fold_left_out),
    ("tsbs-4000-4r.live", writes_dropped),
])
def test_a_broken_path_is_not_correct(small_run, monkeypatch, name, fault):
    out = small_run(name, prepare=fault(monkeypatch))
    assert not out["correct"], out["checks"]
