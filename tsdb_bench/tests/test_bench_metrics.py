"""The metric arithmetic on hand-made windows: rates over the window,
the percentile, span seconds, the device trace and the roofline's byte
count against a hand count."""

import json
import os

import pytest

from tsdb_bench import devtrace
from tsdb_bench.run import Window, metric_reader

from .test_bench_generator import small_cfg


def rec(send, recv, stmt=None, error=None):
    return {"send": send, "recv": recv, "error": error,
            "stmt": stmt or {"type": "t"}}


def window(root, records=(), batches=(), spans=None, device=None,
           writer=False):
    cfg = small_cfg(root)
    mix = {"writer": writer}
    return Window(10.0, 20.0, 33.0, list(records), list(batches), spans,
                  device, cfg, mix)


def read(root, name, w):
    return metric_reader(root, name)(w)


def test_rates_count_the_window_share(root):
    recs = [rec(8.0, 12.0),            # half inside
            rec(12.0, 13.0), rec(13.0, 14.0),
            rec(19.0, 23.0),           # a quarter inside
            rec(14.0, 15.0, error="x"),
            rec(21.0, 22.0)]           # after
    w = window(root, recs)
    assert read(root, "queries_per_s", w) == pytest.approx(
        (0.5 + 1 + 1 + 0.25) / 10)
    b = [{"batch": 1, "send": 9.0, "ack": 11.0, "rows": 4000,
          "error": None},
         {"batch": 2, "send": 11.0, "ack": 12.0, "rows": 4000,
          "error": None},
         {"batch": 3, "send": 12.0, "ack": 13.0, "rows": 4000,
          "error": "refused"}]
    assert read(root, "ingest_rows_per_s", window(root, batches=b)) is None
    assert read(root, "ingest_rows_per_s",
                window(root, batches=b, writer=True)) == pytest.approx(
                    (2000 + 4000) / 10)
    assert read(root, "setup_s", w) == 33.0


def test_p90_is_the_nearest_rank(root):
    recs = [rec(10.0 + i * 0.01, 10.0 + i * 0.01 + (i + 1) / 1000)
            for i in range(100)]
    assert read(root, "query_p90_ms", window(root, recs)) == \
        pytest.approx(90.0)


def test_layers_split_the_client_wall(root):
    # two statements inside; one straddling the end (half inside)
    recs = [rec(11.0, 12.0), rec(12.0, 14.0), rec(19.0, 21.0)]
    spans = [("execute_stmt", 11.1, 11.9), ("tpu_execute", 11.2, 11.8),
             ("region_scan", 11.3, 11.7),
             ("execute_stmt", 12.2, 13.6), ("tpu_execute", 12.3, 13.5),
             ("region_scan", 12.4, 12.9), ("region_scan", 12.9, 13.3),
             ("execute_stmt", 19.1, 20.9), ("tpu_execute", 19.2, 20.8),
             ("region_scan", 19.3, 20.7),
             ("region_flush", 15.0, 16.0), ("compaction", 19.5, 21.5)]
    w = window(root, recs, spans=spans, writer=True)
    n = 2.5
    wall = 1.0 + 2.0 + 1.0
    ex = 0.8 + 1.4 + 0.9
    tp = 0.6 + 1.2 + 0.8
    rs = 0.4 + 0.9 + 0.7
    assert read(root, "flight_ms", w) == pytest.approx((wall - ex) / n * 1e3)
    assert read(root, "frontend_ms", w) == pytest.approx((ex - tp) / n * 1e3)
    assert read(root, "fold_ms", w) == pytest.approx((tp - rs) / n * 1e3)
    assert read(root, "region_scan_ms", w) == pytest.approx(rs / n * 1e3)
    assert read(root, "background_pct", w) == pytest.approx(
        (1.0 + 0.5) / 10 * 100)
    assert read(root, "flight_ms", window(root, recs)) is None


def test_device_trace_busy_idle_and_gaps(root):
    ops = [("k1", 9.0, 10.5), ("k2", 11.0, 12.0), ("copy", 11.5, 12.5),
           ("k1", 19.5, 20.5)]
    spans = [("execute_stmt", 12.0, 19.0), ("region_scan", 13.0, 14.0)]
    t = devtrace.DeviceTrace(ops, spans, 10.0, 20.0)
    assert t.busy_s == pytest.approx(0.5 + 1.5 + 0.5)
    assert t.op_seconds()[0] == ("k1", pytest.approx(1.0))
    gaps = dict(t.gap_seconds_by_span())
    # 10.5-11.0 has no span; 12.5-19.5's middle (16.0) only execute_stmt
    assert gaps[devtrace.NO_SPAN] == pytest.approx(0.5)
    assert gaps["execute_stmt"] == pytest.approx(7.0)
    w = window(root, device=t)
    assert read(root, "device_idle_pct", w) == pytest.approx(75.0)
    assert read(root, "device_idle_pct", window(root)) is None
    bd = t.breakdown()
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_roofline_bytes_against_a_hand_count(root):
    w = window(root)
    cfg = w.cfg
    mod_read = metric_reader(root, "agg_roofline")
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "roof", os.path.join(root, "tsdb_bench", "metrics",
                             "agg_roofline.py"))
    roof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roof)
    t0 = cfg["start_ms"]
    # double-groupby-5 over the whole 12 h of 40 hosts: 40 x 4320 rows,
    # 5 fields of 4 bytes; 40 x 12 groups of 6 moments of 8 bytes
    dg = {"fields": ["f"] * 5, "hosts": None, "a": t0, "b": t0 + 43200_000,
          "bucket_ms": 3600_000, "acked": 0}
    assert roof.bytes_needed(dg, cfg) == 40 * 4320 * 5 * 4 + 40 * 12 * 6 * 8
    # single-groupby over 8 hosts, 1 h from 00:30:05 to 01:30:05 on the
    # 10 s grid: rows at 00:30:10 ... 01:30:00 = 360, 61 minute buckets
    sg = {"fields": ["f"] * 5, "hosts": list(range(8)),
          "a": t0 + 1805_000, "b": t0 + 5405_000, "bucket_ms": 60_000,
          "acked": 0}
    assert roof.rows_selected(sg, cfg) == 8 * 360
    assert roof.groups(sg, cfg) == 8 * 61
    # the live mix's last hour past the table, 30 batches acknowledged
    lv = {"fields": ["f"] * 10, "hosts": list(range(8)),
          "a": t0 + (4320 + 30) * 10_000 - 3600_000,
          "b": t0 + (4320 + 30) * 10_000, "bucket_ms": 60_000,
          "acked": 30}
    assert roof.rows_selected(lv, cfg) == 8 * 360
    need = roof.bytes_needed(dg, cfg)
    t = devtrace.DeviceTrace([("k", 10.0, 10.001)], [], 10.0, 20.0)
    w = window(root, [rec(11.0, 12.0, dg)], device=t)
    assert mod_read(w) == pytest.approx(need / 3.35e12 / 0.001 * 100)
    assert mod_read(window(root, [rec(11.0, 12.0, dg)])) is None


def test_every_metric_has_a_reader(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metric_reader(root, m["name"]))


def test_fused_share_of_scans(root):
    w = window(root)
    assert read(root, "scan_fused_pct", w) is None
    w.counters = {"scan_fusion_leader": 30.0, "scan_fusion_follower": 10.0}
    assert read(root, "scan_fused_pct", w) == pytest.approx(25.0)
    w.counters = {"scan_fusion_leader": 12.0, "scan_fusion_follower": 0.0}
    assert read(root, "scan_fused_pct", w) == 0.0
