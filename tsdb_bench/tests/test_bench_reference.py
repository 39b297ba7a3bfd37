"""The reference against a row-by-row brute force at a tiny size: the
dashboard's windows, the live mix's sliding windows past the table, and
the four-region split; the comparison's verdicts; the control."""

import itertools
import math

import numpy as np

from tsdb_bench import datagen, reference, traffic, tsbs
from tsdb_bench.run import live_values

from .test_bench_generator import small_cfg


def brute(vals, fields, start_ms, iv, stmt, hosts_all):
    """Every row one at a time: {(bucket, hostname): [values]}."""
    groups = {}
    hosts = hosts_all if stmt["hosts"] is None else stmt["hosts"]
    for i in range(vals.shape[1]):
        t = start_ms + i * iv
        if not stmt["a"] <= t < stmt["b"]:
            continue
        b = t // stmt["bucket_ms"] * stmt["bucket_ms"]
        for h in hosts:
            g = groups.setdefault((b, f"host_{h}"), [[] for _ in
                                                     stmt["fields"]])
            for k, f in enumerate(stmt["fields"]):
                g[k].append(float(vals[fields.index(f), i, h]))
    out = {}
    for key, cols in groups.items():
        out[key] = [math.fsum(c) / len(c) if stmt["agg"] == "avg"
                    else max(c) for c in cols]
    return out


def check_against_brute(data, vals, cfg, stmt):
    want = reference.answer(data, stmt)
    bf = brute(vals, cfg["fields"], cfg["start_ms"], cfg["interval_ms"],
               stmt, list(range(vals.shape[2])))
    keys = sorted(bf, key=lambda k: (k[0], k[1]))
    assert list(want["bucket"]) == [k[0] for k in keys]
    assert list(want["host"]) == [k[1] for k in keys]
    for j in range(len(stmt["fields"])):
        got = want["values"][j]
        exp = np.asarray([bf[k][j] for k in keys])
        if stmt["agg"] == "max":
            assert np.array_equal(got, exp)
        else:
            assert np.allclose(got, exp, rtol=1e-14, atol=0)
            assert (want["bounds"][j] > 0).all()


def test_dashboard_windows_match_brute_force(root):
    cfg = small_cfg(root, hosts=6, hours=12)
    _, vals = datagen.table_arrays(11, cfg, "cpu")
    data = reference.Data(vals, cfg["fields"], cfg["start_ms"],
                          cfg["interval_ms"])
    mix = traffic.load_mix(root, "tsbs-dashboard")
    cfg8 = dict(cfg, hosts=6)
    for d in itertools.islice(traffic.draws(mix, cfg8, 5, 0), 10):
        check_against_brute(data, vals, cfg, traffic.bind(d, mix, cfg, 0))


def test_live_windows_slide_past_the_table(root):
    """Windows ending at the last acknowledged batch read the batches the
    writer's walk made, and exactly those."""
    cfg = small_cfg(root, hosts=6, hours=12)
    _, vals = datagen.table_arrays(12, cfg, "cpu")
    mix = traffic.load_mix(root, "tsbs-live")
    ext = live_values(12, vals, 400)
    walk = tsbs.LiveWalk(12, {f: vals[i, -1] for i, f in
                              enumerate(cfg["fields"])})
    for k in range(3):
        step = walk.next()
        for i, f in enumerate(cfg["fields"]):
            assert np.array_equal(ext[i, vals.shape[1] + k], step[f])
    data = reference.Data(ext, cfg["fields"], cfg["start_ms"],
                          cfg["interval_ms"])
    draws = traffic.draws(mix, cfg, 6, 1)
    for acked in (1, 7, 360, 400):
        for _ in range(5):
            s = traffic.bind(next(draws), mix, cfg, acked)
            assert s["b"] == cfg["start_ms"] + (4320 + acked) * 10_000
            check_against_brute(data, ext[:, :4320 + acked], cfg, s)


def test_four_regions_fold_to_the_whole(root):
    """Answers made region by region over the range split of the host
    names, folded by key, are the whole table's answers."""
    cfg = small_cfg(root, hosts=40, hours=12)
    _, vals = datagen.table_arrays(13, cfg, "cpu")
    names = sorted(f"host_{h}" for h in range(40))
    bounds = [names[k * 10] for k in range(1, 4)]
    assert tsbs.range_partition(40, 4) == (
        " PARTITION BY RANGE COLUMNS (hostname) (" + ", ".join(
            f"PARTITION r{i} VALUES LESS THAN ({b})" for i, b in
            enumerate([f"'{x}'" for x in bounds] + ["MAXVALUE"])) + ")")
    region_of = {h: sum(f"host_{h}" >= b for b in bounds)
                 for h in range(40)}
    assert sorted(list(region_of.values()).count(r) for r in range(4)) == \
        [10] * 4
    data = reference.Data(vals, cfg["fields"], cfg["start_ms"],
                          cfg["interval_ms"])
    mix = traffic.load_mix(root, "tsbs-live")
    for d in itertools.islice(traffic.draws(mix, cfg, 8, 0), 5):
        s = traffic.bind(d, mix, cfg, 0)
        whole = reference.answer(data, s)
        parts = {}
        for r in range(4):
            mine = [h for h in range(40) if region_of[h] == r]
            sel = mine if s["hosts"] is None else \
                [h for h in s["hosts"] if region_of[h] == r]
            if not sel:
                continue
            a = reference.answer(data, dict(s, hosts=sel))
            for i in range(len(a["bucket"])):
                parts[(a["bucket"][i], a["host"][i])] = \
                    [v[i] for v in a["values"]]
        keys = list(zip(whole["bucket"], whole["host"]))
        assert sorted(parts) == sorted(keys)
        for i, k in enumerate(keys):
            assert parts[k] == [v[i] for v in whole["values"]]


def test_comparison_verdicts(root):
    cfg = small_cfg(root, hours=12)
    _, vals = datagen.table_arrays(14, cfg, "cpu")
    data = reference.Data(vals, cfg["fields"], cfg["start_ms"],
                          cfg["interval_ms"])
    mix = traffic.load_mix(root, "tsbs-dashboard")
    seen = set()
    for d in traffic.draws(mix, cfg, 3, 0):
        if d["agg"] in seen:
            continue
        seen.add(d["agg"])
        s = traffic.bind(d, mix, cfg, 0)
        want = reference.answer(data, s)
        # the float32 mirror's own rounding passes
        f32 = dict(want, values=[
            v.astype(np.float32).astype(np.float64) if s["agg"] == "max"
            else v for v in want["values"]])
        c = reference.compare(f32, want, s["agg"])
        assert c["mismatches"] == 0 and c["worst"] <= 1.0
        # a value altered, a row missing, the bfloat16 control: refused
        bad = dict(want, values=[v.copy() for v in want["values"]])
        bad["values"][0][3] *= 1 + 1e-4
        c = reference.compare(bad, want, s["agg"])
        assert c["mismatches"] > 0 or c["worst"] > 1.0
        short = {k: (v[1:] if k != "values" else [x[1:] for x in v])
                 for k, v in want.items() if k != "bounds"}
        assert reference.compare(short, want, s["agg"])["mismatches"] > 0
        ctl = reference.answer(data, s, precision="bfloat16")
        c = reference.compare(ctl, want, s["agg"])
        assert c["mismatches"] > 0 or c["worst"] > 100.0
        if len(seen) == 2:
            break


def test_bfloat16_rounding():
    # 1 + 2^-8 ties to the even 1.0; 1 + 3 * 2^-8 ties to the even
    # 1 + 2^-6; 1 + 2^-9 rounds down
    x = np.array([1.0, 1.00390625, 1.01171875, 1.001953125, 3.14159, 100.0,
                  0.0])
    r = reference.to_bfloat16(x)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.015625 and r[3] == 1.0
    r = r[1:]
    assert abs(r[3] - 3.140625) < 1e-9 and r[4] == 100.0 and r[5] == 0.0
