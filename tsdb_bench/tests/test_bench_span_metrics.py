"""The stage-span metrics (scan_masks_ms, scan_copy_ms, scan_collect_ms,
finalize_ms, plan_ms, flight_encode_ms): their sums on a hand-made
window, a span across the window's edge counting by its share inside;
nothing where the program opens none of their spans; an entry and a
reader for each; and a traced run on the CPU that reports all six."""

import pytest

from tsdb_bench import run
from tsdb_bench.run import metric_reader

from .conftest import load_bench
from .test_bench_metrics import rec, window

#: metric -> the spans it sums
STAGE_METRICS = {
    "scan_masks_ms": ("scan_runs", "scan_masks"),
    "scan_copy_ms": ("scan_h2d", "scan_launch", "scan_fetch"),
    "scan_collect_ms": ("scan_collect",),
    "finalize_ms": ("finalize",),
    "plan_ms": ("parse_sql", "plan", "project"),
    "flight_encode_ms": ("flight_encode",),
}


def stage_spans(at, names, step=0.1):
    """One span of each name after the other from `at`, `step` seconds
    each."""
    return [(n, at + i * step, at + (i + 1) * step)
            for i, n in enumerate(names)]


@pytest.mark.parametrize("metric", list(STAGE_METRICS))
def test_stage_metric_sums_its_spans(root, metric):
    names = STAGE_METRICS[metric]
    # two statements inside the window, a third half inside at its end
    recs = [rec(11.0, 12.0), rec(12.0, 14.0), rec(19.0, 21.0)]
    spans = (stage_spans(11.1, names) + stage_spans(12.1, names, 0.2) +
             # straddles the end: 0.05 s of its 0.1 s inside
             [(names[0], 19.95, 20.05)] +
             # before the window, and spans no metric here reads
             [(names[-1], 9.0, 9.5), ("region_scan", 11.0, 11.9),
              ("scan_fusion_wait", 12.0, 12.5)])
    w = window(root, recs, spans=spans)
    want = (0.1 * len(names) + 0.2 * len(names) + 0.05) / 2.5 * 1e3
    assert metric_reader(root, metric)(w) == pytest.approx(want)


@pytest.mark.parametrize("metric", list(STAGE_METRICS))
def test_stage_metric_reads_nothing_without_its_spans(root, metric):
    """A program that opens none of the spans (the parent of the change
    that added them), an untraced run, a window with no statement."""
    recs = [rec(11.0, 12.0)]
    read = metric_reader(root, metric)
    older = [("execute_stmt", 11.1, 11.9), ("tpu_execute", 11.2, 11.8),
             ("region_scan", 11.3, 11.7)]
    assert read(window(root, recs, spans=older)) is None
    assert read(window(root, recs)) is None
    spans = stage_spans(11.1, STAGE_METRICS[metric])
    assert read(window(root, [], spans=spans)) is None


def test_every_stage_metric_has_its_entry_and_reader(root):
    bench = load_bench(root)
    entries = {m["name"]: m for m in bench["per_layer"]}
    layers = {"scan_masks_ms": "query/tpu_exec region reduce",
              "scan_copy_ms": "query/tpu_exec region reduce",
              "scan_collect_ms": "query/tpu_exec region reduce",
              "finalize_ms": "query/ir",
              "plan_ms": "frontend + query engine",
              "flight_encode_ms": "servers/flight"}
    for name, layer in layers.items():
        assert entries[name] == {
            "name": name, "unit": "ms", "better": "lower",
            "source": "program_span", "layer": layer,
            "moves": "queries_per_s", "workloads": ["tsbs-4000.dashboard"]}
        assert callable(metric_reader(root, name))
    # the new entries come after every entry the benchmark had
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-len(layers):] == list(layers)


def test_a_traced_cpu_run_reports_every_stage_metric(root, monkeypatch):
    from greptimedb_tpu_torch.query import tpu_exec
    monkeypatch.setattr(tpu_exec, "_dispatch_min_rows", lambda: 0)
    cell = run.Cell(root, load_bench(root), "tsbs-4000.dashboard")
    cell.cfg = dict(cell.cfg, hosts=16, hours=12)
    out = run.run_cell(root, cell, 2**31 + 7, 2.0, trace=True,
                       device="cpu")
    assert out["correct"], out["checks"]
    for name in STAGE_METRICS:
        assert out["metrics"][name]["value"] > 0, name
        assert out["metrics"][name]["unit"] == "ms"
