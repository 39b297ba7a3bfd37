"""A later change adds a configuration, a mix and a metric as new files
and entries: the harness finds them by name and runs the new cell,
without an edit to a file that is there."""

import json
import os
import shutil

from tsdb_bench import run


def test_added_files_are_found_and_run(root, tmp_path, monkeypatch):
    new = tmp_path / "checkout"
    shutil.copytree(os.path.join(root, "tsdb_bench"), new / "tsdb_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(root, "tsdb_bench", "configs",
                           "tsbs-cpu-4000h-24h.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tsbs-cpu-24h-small", hosts=24, hours=12)
    (new / "tsdb_bench" / "configs" / "tsbs-cpu-24h-small.json").write_text(
        json.dumps(cfg))
    mix = {"readers": 2, "writer": False, "window_end": "random",
           "compare_share": 1.0,
           "statements": [
               {"name": "double-groupby-2-30m", "agg": "avg", "fields": 2,
                "hosts": "all", "span_s": 7200, "bucket": "30 minutes"},
               {"name": "cpu-max-3-4", "agg": "max", "fields": 3,
                "hosts": 4, "span_s": 3600, "bucket": "10 minutes"}]}
    (new / "tsdb_bench" / "mixes" / "small-mix.json").write_text(
        json.dumps(mix))
    (new / "tsdb_bench" / "metrics" / "statements_done.py").write_text(
        "def read(w):\n    return float(len(w.done))\n")
    bench["configs"].append({"name": "tsbs-cpu-24h-small", "source": "x",
                             "file": "tsdb_bench/configs/"
                                     "tsbs-cpu-24h-small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "small.cell",
                               "config": "tsbs-cpu-24h-small",
                               "traffic": "small-mix", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "statements_done", "unit": "n",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["small.cell"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = run.Cell(str(new), bench, "small.cell")
    assert cell.cfg["hosts"] == 24 and cell.mix["readers"] == 2
    assert [m["name"] for m in cell.end_to_end] == \
        ["queries_per_s", "setup_s", "statements_done"]
    assert callable(run.metric_reader(str(new), "statements_done"))

    from greptimedb_tpu_torch.query import tpu_exec
    monkeypatch.setattr(tpu_exec, "_dispatch_min_rows", lambda: 0)
    out = run.run_cell(root, cell, seed=5, seconds=2.0, trace=False,
                       device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["statements_done"]["value"] > 0
    assert set(out["metrics"]) == {"queries_per_s", "setup_s",
                                   "statements_done"}
