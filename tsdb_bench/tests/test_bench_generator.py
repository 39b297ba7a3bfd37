"""The generator and the mixes repeat exactly from the seed."""

import itertools
import json
import os

import numpy as np

from tsdb_bench import datagen, traffic, tsbs


def small_cfg(root, name="tsbs-cpu-4000h-24h", **kw):
    with open(os.path.join(root, "tsdb_bench", "configs",
                           f"{name}.json")) as f:
        cfg = json.load(f)
    cfg.update({"hosts": 40, "hours": 12, **kw})
    return cfg


def test_values_repeat_from_the_seed(root):
    cfg = small_cfg(root)
    for seed in (0, 2**31 + 5, -3, 2**70 + 1):
        ts1, v1 = datagen.table_arrays(seed, cfg, "cpu")
        ts2, v2 = datagen.table_arrays(seed, cfg, "cpu")
        assert np.array_equal(ts1, ts2) and np.array_equal(v1, v2)
        assert v1.shape == (10, 4320, 40)
        assert v1.min() >= 0.0 and v1.max() <= 100.0
    _, a = datagen.table_arrays(1, cfg, "cpu")
    _, b = datagen.table_arrays(2, cfg, "cpu")
    assert not np.array_equal(a, b)


def test_walk_steps_are_tsbs_steps(root):
    """Each step of a walk is N(0, 1), clamped to [0, 100]."""
    cfg = small_cfg(root)
    _, v = datagen.table_arrays(3, cfg, "cpu")
    d = np.diff(v, axis=1)
    inside = (v[:, 1:] > 0) & (v[:, 1:] < 100) & (v[:, :-1] > 0) & \
        (v[:, :-1] < 100)
    steps = d[inside]
    assert abs(steps.mean()) < 0.02 and abs(steps.std() - 1.0) < 0.02


def test_tags_and_live_batches_repeat(root):
    assert tsbs.host_tags(7, 40) == tsbs.host_tags(7, 40)
    tags = tsbs.host_tags(7, 40)
    assert [t[0] for t in tags] == [f"host_{h}" for h in range(40)]
    assert all(t[1] in tsbs.TSBS_REGIONS and t[2] in tsbs.TSBS_REGIONS[t[1]]
               for t in tags)
    last = {f: np.full(40, 50.0) for f in tsbs.CPU_FIELDS}
    a, b = tsbs.LiveWalk(7, last), tsbs.LiveWalk(7, last)
    for _ in range(5):
        x, y = a.next(), b.next()
        assert all(np.array_equal(x[f], y[f]) for f in tsbs.CPU_FIELDS)


def test_mix_draws_repeat_and_cover_every_type(root):
    cfg = small_cfg(root)
    for name in ("tsbs-dashboard", "tsbs-live"):
        mix = traffic.load_mix(root, name)
        k = len(mix["statements"])
        for r in range(mix["readers"]):
            one = list(itertools.islice(traffic.draws(mix, cfg, 9, r), 4 * k))
            two = list(itertools.islice(traffic.draws(mix, cfg, 9, r), 4 * k))
            assert one == two
            for i in range(4):
                rnd = {d["type"] for d in one[i * k:(i + 1) * k]}
                assert rnd == {s["name"] for s in mix["statements"]}
        other = list(itertools.islice(traffic.draws(mix, cfg, 10, 0), 4 * k))
        assert other != list(itertools.islice(traffic.draws(mix, cfg, 9, 0),
                                              4 * k))


def test_windows_lie_on_the_grid_inside_the_table(root):
    cfg = small_cfg(root)
    n = 4320
    end = cfg["start_ms"] + n * cfg["interval_ms"]
    mix = traffic.load_mix(root, "tsbs-dashboard")
    for d in itertools.islice(traffic.draws(mix, cfg, 4, 0), 200):
        s = traffic.bind(d, mix, cfg, 0)
        assert cfg["start_ms"] <= s["a"] < s["b"] <= end
        assert (s["a"] - cfg["start_ms"]) % cfg["interval_ms"] == 0
        assert s["b"] - s["a"] == s["span_ms"]
    live = traffic.load_mix(root, "tsbs-live")
    d = next(traffic.draws(live, cfg, 4, 0))
    s = traffic.bind(d, live, cfg, 17)
    assert s["b"] == end + 17 * cfg["interval_ms"]
    sql = traffic.sql(s, "cpu")
    assert f"ts < {s['b']}" in sql and "GROUP BY bucket, hostname" in sql


def test_random_windows_differ_between_statements(root):
    """The table spans more than the longest window, so each statement's
    window is drawn from the seed: at the configuration's own size no two
    double-groupby statements of the first rounds of four readers share
    one, and scans of identical statements cannot merge by chance."""
    with open(os.path.join(root, "tsdb_bench", "configs",
                           "tsbs-cpu-4000h-24h.json")) as f:
        cfg = json.load(f)
    mix = traffic.load_mix(root, "tsbs-dashboard")
    assert all(cfg["hours"] * 3600 >= 2 * s["span_s"]
               for s in mix["statements"])
    seen = []
    for r in range(mix["readers"]):
        for d in itertools.islice(traffic.draws(mix, cfg, 123, r), 40):
            if d["type"].startswith("double-groupby"):
                s = traffic.bind(d, mix, cfg, 0)
                seen.append((s["type"], s["a"]))
    assert len(seen) >= 80 and len(set(seen)) >= len(seen) - 2
