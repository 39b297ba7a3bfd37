"""The port's PromQL engine against the JAX package's, through the
Prometheus-API entry point `query_to_prom_json`.

Both engines get the same in-memory series through one `select` override
(the engine's data-access seam), which applies the selector's matchers the
way promql/lowering.py:select_series does. The reference runs JAX on the
CPU; the port runs torch with `device="cpu"`.

Results must name the same series at the same timestamps; values, parsed
as floats, agree within rtol 1e-5 (the engines print 6 significant
digits, so one rounding step apart is allowed). Gauge values are multiples
of 0.5 and sample times whole seconds, so every float32 prefix sum is
exact in any summation order. The epilogues that cancel (the variance
E[x^2] - E[x]^2 and the least-squares slope) round where XLA and torch
contract or reassociate float32 products differently, so queries through
them also accept an absolute error of 8 * eps32 * max|gauge|
(`CANCEL_ATOL`); the gauge is centred on 0 to keep that small.

The last test loads the same `cpu` series into a table of each
package's standalone frontend and holds the port's region-backed
`select` (promql/lowering.py) to the reference's.
"""

import math

import numpy as np
import pytest
import torch

from greptimedb_tpu.ops import window as jwin
from greptimedb_tpu.promql import engine as jeng
from greptimedb_tpu_torch.ops import window as twin
from greptimedb_tpu_torch.promql import engine as teng

# tiny tensors: one intra-op thread keeps parallel test workers off
# each other's cores
torch.set_num_threads(1)

BASE_MS = 1_700_000_000_000
HOUR_MS = 3_600_000
GAUGE_MAX = 25.0
CANCEL_ATOL = 8 * float(np.finfo(np.float32).eps) * GAUGE_MAX
CANCELLING = ("stddev_over_time", "deriv", "predict_linear")


def _store(seed: int = 5):
    """metric → [(labels, ts ms int64, values float64)]."""
    rng = np.random.default_rng(seed)
    out = {"cpu": [], "mem": [], "reqs_total": [], "epoch": []}
    for i, host in enumerate(["a", "b", "c", "d"]):
        n = 230
        ts = BASE_MS + np.sort(rng.choice(np.arange(0, HOUR_MS // 1000, 15),
                                          n, replace=False)) * 1000
        ts = ts + rng.integers(0, 5, n) * 1000         # whole seconds
        ts = np.unique(ts)
        if host == "d":
            ts = ts[ts < BASE_MS + HOUR_MS // 2]       # stops half-way
        v = np.clip(np.round(np.cumsum(rng.normal(0, 2, len(ts))) * 2) / 2,
                    -GAUGE_MAX, GAUGE_MAX)
        out["cpu"].append(({"host": host,
                            "region": "east" if i % 2 else "west"}, ts, v))
        out["mem"].append(({"host": host, "job": "node"}, ts[::2],
                           np.round(rng.random(len(ts[::2])) * 200) / 2))
    for host in ["a", "b", "c"]:
        for code in ["200", "500"]:
            ts = BASE_MS + np.arange(0, HOUR_MS, 10_000)
            inc = np.round(rng.random(len(ts)) * 8) / 2
            v = np.cumsum(inc)
            for r in rng.integers(10, len(ts) - 10, 2):
                v[r:] -= v[r]                          # counter resets
            if host == "c":
                v = v - 3.0                            # negative first
            out["reqs_total"].append(({"host": host, "code": code}, ts, v))
    # sample values that are themselves epoch seconds (1906..2096), for
    # the calendar functions
    ts = BASE_MS + np.arange(0, HOUR_MS, 60_000)
    for k in range(3):
        out["epoch"].append(({"k": str(k)}, ts, rng.integers(
            -2_000_000_000, 4_000_000_000, len(ts)).astype(np.float64)))
    return out


STORE = _store()


def _mem_select(eng_mod, win_mod, sel, lo_ms, hi_ms):
    metric = sel.metric
    for m in sel.matchers:
        if m.name == "__name__" and m.op == "=":
            metric = m.value
    glabels, gids, tss, vals = [], [], [], []
    for tags, ts, v in STORE.get(metric, []):
        keep = True
        for m in sel.matchers:
            if m.name in ("__name__", "__field__"):
                continue
            if m.name not in tags:
                keep &= eng_mod._matches_empty(m)
            else:
                keep &= bool(eng_mod._matcher_keep([tags[m.name]], m)[0])
        rk = (ts >= lo_ms) & (ts <= hi_ms)
        if not keep or not rk.any():
            continue
        gids.append(np.full(int(rk.sum()), len(glabels)))
        glabels.append({"__name__": metric, **tags})
        tss.append(ts[rk])
        vals.append(v[rk])
    if not glabels:
        return eng_mod._Selection([], None)
    ts = np.concatenate(tss)
    sm = win_mod.SeriesMatrix.build(np.concatenate(gids), ts,
                                    np.concatenate(vals), len(glabels))
    return eng_mod._Selection(glabels, sm, int(ts.min()), int(ts.max()))


class _NoTables:
    def table(self, *args):
        return None


class JaxMemEngine(jeng.PromqlEngine):
    def select(self, sel, lo_ms, hi_ms, ctx):
        return _mem_select(jeng, jwin, sel, lo_ms, hi_ms)


class TorchMemEngine(teng.PromqlEngine):
    def select(self, sel, lo_ms, hi_ms, ctx):
        return _mem_select(teng, twin, sel, lo_ms, hi_ms)


@pytest.fixture(scope="module")
def engines():
    return JaxMemEngine(_NoTables()), TorchMemEngine(_NoTables(),
                                                     device="cpu")


AT_S = (BASE_MS + 20 * 60_000) // 1000

RANGE_QUERIES = [
    "rate(reqs_total[5m])",
    "increase(reqs_total[2m])",
    "irate(reqs_total[1m])",
    "resets(reqs_total[10m])",
    "delta(cpu[3m])",
    "idelta(cpu[3m])",
    "avg_over_time(cpu[5m])",
    "stddev_over_time(cpu[5m])",
    "sum_over_time(cpu[90s])",
    "count_over_time(cpu[5m])",
    "changes(cpu[10m])",
    "last_over_time(cpu[5m] offset 2m)",
    "max_over_time(cpu[5m])",
    "quantile_over_time(0.9, cpu[5m])",
    "deriv(cpu[2m])",
    "predict_linear(cpu[2m], 60)",
    "holt_winters(cpu[10m], 0.5, 0.3)",
    'sum by (code) (rate(reqs_total[5m]))',
    "sum without (host) (cpu)",
    "avg by (region) (cpu offset 5m)",
    "rate(reqs_total[5m]) / on(host) group_left "
    "sum by (host) (rate(reqs_total[5m]))",
    'cpu{host=~"a|b"} > on(host) mem / 4',
    "mem unless on(host) cpu{region=\"east\"}",
    "topk(2, cpu) * 2 + 1",
    f"rate(reqs_total[5m] @ {AT_S})",
    f"cpu @ {AT_S}",
    "timestamp(cpu)",
    "absent_over_time(nothing[5m])",
    "hour()",
]

INSTANT_QUERIES = [
    "rate(reqs_total[5m])",
    "avg_over_time(cpu[5m])",
    'sum by (region) (max_over_time(cpu{host!="d"}[5m]))',
    "cpu[2m]",
    "cpu offset 1m",
    "scalar(sum(cpu)) - 1",
]


def _values_equal(a, b, atol=0.0):
    fa, fb = float(a), float(b)
    if math.isnan(fa) or math.isnan(fb):
        return math.isnan(fa) and math.isnan(fb)
    if math.isinf(fa) or math.isinf(fb):
        return fa == fb
    return math.isclose(fa, fb, rel_tol=1e-5, abs_tol=atol)


def _assert_same(want, got, q):
    atol = CANCEL_ATOL if q.startswith(CANCELLING) else 0.0
    assert got["resultType"] == want["resultType"], q
    if want["resultType"] in ("scalar", "string"):
        assert got["result"][0] == want["result"][0], q
        assert _values_equal(got["result"][1], want["result"][1]), q
        return
    assert [r["metric"] for r in got["result"]] == \
        [r["metric"] for r in want["result"]], q
    key = "values" if want["resultType"] == "matrix" else "value"
    for rw, rg in zip(want["result"], got["result"]):
        pw = rw[key] if key == "values" else [rw[key]]
        pg = rg[key] if key == "values" else [rg[key]]
        assert [float(t) for t, _ in pg] == [float(t) for t, _ in pw], q
        bad = [(t, x, y) for (t, x), (_, y) in zip(pw, pg)
               if not _values_equal(x, y, atol)]
        assert not bad, f"{q}: {bad[:3]}"


@pytest.mark.parametrize("query", RANGE_QUERIES)
def test_range_query_matches_reference(engines, query):
    jax_eng, torch_eng = engines
    start, end, step = BASE_MS, BASE_MS + HOUR_MS, 60_000
    want = jax_eng.query_to_prom_json(query, start, end, step)
    got = torch_eng.query_to_prom_json(query, start, end, step)
    if query not in ("absent_over_time(nothing[5m])",):
        assert want["result"], f"{query}: empty reference result"
    _assert_same(want, got, query)


@pytest.mark.parametrize("query", INSTANT_QUERIES)
def test_instant_query_matches_reference(engines, query):
    jax_eng, torch_eng = engines
    t = BASE_MS + 25 * 60_000 + 7_000
    want = jax_eng.query_to_prom_json(query, t, t, 1, instant=True)
    got = torch_eng.query_to_prom_json(query, t, t, 1, instant=True)
    assert want["result"], query
    _assert_same(want, got, query)


@pytest.mark.parametrize("func", [
    "minute", "hour", "day_of_week", "day_of_month", "day_of_year",
    "days_in_month", "month", "year"])
def test_calendar_functions_match_reference(engines, func):
    """The port computes calendar fields with numpy datetime64 where the
    reference uses pandas."""
    jax_eng, torch_eng = engines
    start, end, step = BASE_MS, BASE_MS + HOUR_MS, 60_000
    q = f"{func}(epoch)"
    want = jax_eng.query_to_prom_json(q, start, end, step)
    got = torch_eng.query_to_prom_json(q, start, end, step)
    assert want["result"]
    _assert_same(want, got, q)


def test_query_range_value_types(engines):
    jax_eng, torch_eng = engines
    args = ("rate(reqs_total[5m])", BASE_MS, BASE_MS + HOUR_MS, 30_000)
    (jv, jsteps), (tv, tsteps) = jax_eng.query_range(*args), \
        torch_eng.query_range(*args)
    np.testing.assert_array_equal(tsteps, jsteps)
    assert type(tv).__name__ == type(jv).__name__ == "VectorVal"
    np.testing.assert_array_equal(tv.ok, jv.ok)
    np.testing.assert_allclose(tv.values[tv.ok], jv.values[jv.ok],
                               rtol=1e-5)


def _table_frontends(tmp_path):
    """Both packages' standalone frontends with STORE's `cpu` series
    loaded into a table of the same name (tags host and region, one
    DOUBLE field), by handle_bulk_load."""
    from greptimedb_tpu.datanode import DatanodeInstance, DatanodeOptions
    from greptimedb_tpu.frontend import FrontendInstance
    from greptimedb_tpu_torch.datanode import \
        DatanodeOptions as PortOptions
    from greptimedb_tpu_torch.frontend import build_standalone
    cols = {"host": [], "region": [], "ts": [], "val": []}
    for tags, ts, v in STORE["cpu"]:
        cols["host"] += [tags["host"]] * len(ts)
        cols["region"] += [tags["region"]] * len(ts)
        cols["ts"].append(ts)
        cols["val"].append(v)
    cols = {"host": np.array(cols["host"], dtype=object),
            "region": np.array(cols["region"], dtype=object),
            "ts": np.concatenate(cols["ts"]),
            "val": np.concatenate(cols["val"])}
    ref = FrontendInstance(DatanodeInstance(DatanodeOptions(
        data_home=str(tmp_path / "ref"), register_numbers_table=False)))
    ref.start()
    port = build_standalone(PortOptions(
        data_home=str(tmp_path / "port"), register_numbers_table=False,
        device="cpu"))
    for fe in (ref, port):
        fe.handle_bulk_load("cpu", dict(cols), tag_columns=["host", "region"],
                            timestamp_column="ts")
    return ref, port


def test_port_select_over_a_table_matches_reference(engines, tmp_path):
    """The port's `select` over a region-backed table (promql/lowering.py
    select_series) returns the reference's selection: the same labels,
    timestamps and values; and a query over the table answers as the
    in-memory seam serving the same series does."""
    from greptimedb_tpu.promql.parser import parse_promql as ref_parse
    from greptimedb_tpu.session import QueryContext as RefCtx
    from greptimedb_tpu_torch.promql.parser import parse_promql
    from greptimedb_tpu_torch.session import QueryContext
    ref, port = _table_frontends(tmp_path)
    try:
        lo, hi = BASE_MS, BASE_MS + HOUR_MS
        for text in ("cpu", 'cpu{host="b"}', 'cpu{region=~"e.*"}',
                     'cpu{host!="a", region="west"}'):
            want = ref.promql_engine().select(ref_parse(text), lo, hi,
                                              RefCtx())
            got = port.promql_engine().select(parse_promql(text), lo, hi,
                                              QueryContext())
            assert want.labels and got.labels == want.labels, text
            assert (got.data_min, got.data_max) == \
                (want.data_min, want.data_max), text
            for name in ("ts", "values", "lengths"):
                np.testing.assert_array_equal(
                    getattr(got.matrix, name), getattr(want.matrix, name),
                    err_msg=f"{text}: {name}")
        _, mem = engines
        for q in ("avg_over_time(cpu[5m])", 'sum by (region) (cpu)'):
            args = (q, lo, hi, 60_000)
            assert port.promql_engine().query_to_prom_json(*args) == \
                mem.query_to_prom_json(*args), q
    finally:
        ref.shutdown()
        port.shutdown()
