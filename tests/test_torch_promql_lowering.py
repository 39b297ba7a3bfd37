"""PromQL over tables: the port's promql/lowering.py, its region-backed
`PromqlEngine.select` and TQL against the JAX package's, on the CPU.

Both packages' standalone frontends get the same rows: the counter `ctr`
of tests/test_plan_ir.py (six hosts, two tags, gaps and counter resets)
with NULL samples added, and a gauge `gg` with NULL samples and one host
whose `dc` tag is empty. Each table has its first rows flushed to an SST
and the rest in the memtable. The reference's queries, span and
fixture shape are tests/test_plan_ir.py's, so the reference compiles the
same few programs.

- Lowered path (dispatch floor 0 in both packages): `query_range` ok
  masks and labels exact, values within rtol 2e-5 (the reference's own
  lowered-vs-row tolerance, tests/test_plan_ir.py); TQL EVAL through
  `do_query` byte-equal after `pretty_print`.
- Row path (floor 10^9), plus the shapes that never lower: values within
  rtol 1e-5 of the 6-digit quantised answers, and `query_to_prom_json`
  equal as tests/test_torch_promql.py compares it.
- Lowered against row path inside the port, rtol 2e-5.
- The region-backed select over the scan cache (cold), the streamed cold
  read and the SST index: labels, timestamps and values exact.
- The `reset_corr` moment: the host reducer, both of `_finalize`'s folds
  (a slice boundary that crosses a reset included) and the plan codec,
  exact.
- TQL EXPLAIN byte-equal on both routes; TQL ANALYZE with the same
  stages and rows, elapsed times masked.
"""

import re
import types

import numpy as np
import pandas as pd
import pytest
import torch

from greptimedb_tpu.datanode import DatanodeInstance as RefDatanode
from greptimedb_tpu.datanode import DatanodeOptions as RefOptions
from greptimedb_tpu.datatypes.record_batch import pretty_print as ref_pretty
from greptimedb_tpu.frontend import FrontendInstance as RefFrontend
from greptimedb_tpu.promql import lowering as ref_low
from greptimedb_tpu.promql.parser import parse_promql as ref_parse_promql
from greptimedb_tpu.query import ir as ref_ir
from greptimedb_tpu.query import plan_codec as ref_codec
from greptimedb_tpu.query import stream_exec as ref_stream
from greptimedb_tpu.query import tpu_exec as ref_exec
from greptimedb_tpu.session import QueryContext as RefCtx
from greptimedb_tpu.storage.series import SeriesDict as RefSeriesDict
from greptimedb_tpu_torch.common import telemetry
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.datatypes.record_batch import pretty_print
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.promql import lowering
from greptimedb_tpu_torch.promql.parser import parse_promql
from greptimedb_tpu_torch.query import ir, plan_codec, stream_exec, tpu_exec
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.storage.series import SeriesDict
from test_plan_ir import DDL, QUERIES, SPAN, _assert_close, _seed_rows
from test_torch_promql import _assert_same as assert_same_json

torch.set_num_threads(1)

GG_DDL = DDL.replace("ctr", "gg")
#: gauge shapes that lower, beside the counter's QUERIES
GAUGE_QUERIES = [
    "avg by (dc) (avg_over_time(gg[1m]))",
    "max by (host) (gg)",
    "sum (count_over_time(gg[1m]))",
    "min by (dc) (min_over_time(gg{host!='h2'}[1m]))",
    "count by (dc) (gg{dc!=''})",
]
LOWERED = QUERIES + GAUGE_QUERIES
#: shapes that never lower: an outer aggregate with per-sample semantics,
#: range != step, stddev, regex matchers, @ and = "" matchers
ROW_ONLY = [
    "topk(2, ctr)",
    "rate(ctr[2m])",
    "stddev by (host) (ctr)",
    "sum by (host) (rate(ctr{host=~'h[12]'}[1m]))",
    "sum by (dc) (rate(ctr[1m] @ 400))",
    "sum by (host) (gg{dc=''})",
    "gg{dc=''}",
    "avg_over_time(gg[1m])",
]
SELECTORS = ["ctr", "gg", "ctr{host!='h1'}", "gg{dc=''}",
             "gg{host=~'h[0-2]'}", "ctr{host='h2', dc='dc0'}"]
SIDES = ("ref", "port")


def _split_rows(text):
    return re.findall(r"\([^()]*\)", text)


def _ts_of(row):
    return int(row.split(", ")[2])


def _gauge_rows():
    """A gauge walk in steps of 0.5 with gaps and NULL samples, and h6,
    whose dc tag is empty (a label that is absent)."""
    rng = np.random.default_rng(12)
    rows = []
    for h in range(7):
        v = float(rng.integers(-20, 20))
        dc = "''" if h == 6 else f"'dc{h % 2}'"
        for i in range(80):
            if rng.random() < 0.15:
                continue
            v += float(rng.integers(-6, 7)) / 2
            val = "NULL" if rng.random() < 0.08 else repr(v)
            rows.append(f"('h{h}', {dc}, {i * 10_000}, {val})")
    return rows


def _data():
    """(first batch, second batch) of INSERT statements: the second
    carries the counter's NULL samples, between its regular ones."""
    ctr = _split_rows(_seed_rows())
    ctr_nulls = [f"('h{h}', 'dc{h % 2}', {i * 10_000 + 5_000}, NULL)"
                 for h in (1, 4) for i in (10, 11, 40, 41, 70)]
    gg = _gauge_rows()
    cut = 400_000
    first = [("ctr", [r for r in ctr if _ts_of(r) < cut]),
             ("gg", [r for r in gg if _ts_of(r) < cut])]
    second = [("ctr", [r for r in ctr if _ts_of(r) >= cut] + ctr_nulls),
              ("gg", [r for r in gg if _ts_of(r) >= cut])]
    return first, second


def _open(side, home):
    if side == "ref":
        fe = RefFrontend(RefDatanode(RefOptions(
            data_home=str(home), register_numbers_table=False)))
        fe.start()
        return fe
    return build_standalone(DatanodeOptions(
        data_home=str(home), register_numbers_table=False, device="cpu"))


def _ctx(side):
    return RefCtx() if side == "ref" else QueryContext()


def _clear_caches():
    for mod in (ref_exec, tpu_exec):
        with mod.SCAN_CACHE._lock:
            mod.SCAN_CACHE._entries.clear()


@pytest.fixture(scope="module")
def fes(tmp_path_factory):
    first, second = _data()
    out = {}
    try:
        for side in SIDES:
            fe = _open(side, tmp_path_factory.mktemp(side))
            out[side] = fe
            ctx = _ctx(side)
            fe.do_query(DDL, ctx)
            fe.do_query(GG_DDL, ctx)
            for name, rows in first:
                fe.do_query(f"INSERT INTO {name} VALUES " + ",".join(rows),
                            ctx)
                fe.do_query(f"ADMIN FLUSH TABLE {name}", ctx)
            for name, rows in second:
                fe.do_query(f"INSERT INTO {name} VALUES " + ",".join(rows),
                            ctx)
        yield out
    finally:
        for fe in out.values():
            fe.shutdown()
        _clear_caches()


@pytest.fixture()
def floor(monkeypatch):
    """Pins both packages' dispatch floor (and the adaptive floor each
    device query raises) for one test."""
    def pin(rows):
        for mod in (ref_exec, tpu_exec):
            monkeypatch.setattr(mod, "TPU_DISPATCH_MIN_ROWS", rows)
            monkeypatch.setattr(mod, "_observed_min_dt", [None])
    _clear_caches()
    return pin


def _vec(fe, q, span=SPAN):
    v, _ = fe.promql_engine().query_range(q, span[0], span[1], span[2])
    return {tuple(sorted(lbl.items())): (v.values[i], v.ok[i])
            for i, lbl in enumerate(v.labels)}


def _tql(fe, side, q, span=SPAN, verb="EVAL"):
    pp = ref_pretty if side == "ref" else pretty_print
    return pp(fe.do_query(
        f"TQL {verb} ({span[0] // 1000}, {span[1] // 1000}, "
        f"'{span[2] // 1000}s') {q}", _ctx(side))[0].batches)


def _count_lowered(monkeypatch):
    """Counts eval_lowered calls per package."""
    calls = {"ref": 0, "port": 0}
    for side, mod in (("ref", ref_low), ("port", lowering)):
        inner = mod.eval_lowered

        def spy(ev, low, _inner=inner, _side=side):
            calls[_side] += 1
            return _inner(ev, low)
        monkeypatch.setattr(mod, "eval_lowered", spy)
    return calls


# ---------------------------------------------------------------------------
# lowered path, row path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", LOWERED)
def test_lowered_matches_reference(fes, floor, monkeypatch, q):
    floor(0)
    calls = _count_lowered(monkeypatch)
    want, got = _vec(fes["ref"], q), _vec(fes["port"], q)
    assert calls == {"ref": 1, "port": 1}, calls
    assert want, q
    _assert_close(got, want, rtol=2e-5)
    assert _tql(fes["port"], "port", q) == _tql(fes["ref"], "ref", q)


@pytest.mark.parametrize("q", LOWERED + ROW_ONLY)
def test_row_path_matches_reference(fes, floor, monkeypatch, q):
    floor(10 ** 9)
    calls = _count_lowered(monkeypatch)
    want, got = _vec(fes["ref"], q), _vec(fes["port"], q)
    assert want, q
    _assert_close(got, want, rtol=1e-5)
    span = (SPAN[0], SPAN[1], SPAN[2])
    assert_same_json(
        fes["ref"].promql_engine().query_to_prom_json(q, *span),
        fes["port"].promql_engine().query_to_prom_json(q, *span), q)
    assert calls == {"ref": 0, "port": 0}, calls


@pytest.mark.parametrize("q", LOWERED)
def test_lowered_matches_row_path_in_port(fes, floor, q):
    floor(10 ** 9)
    row = _vec(fes["port"], q)
    floor(0)
    _assert_close(_vec(fes["port"], q), row, rtol=2e-5)


def test_row_only_shapes_do_not_lower(fes, floor, monkeypatch):
    floor(0)
    calls = _count_lowered(monkeypatch)
    for q in ROW_ONLY:
        _vec(fes["port"], q)
    assert calls["port"] == 0


def _reference_keys(df, cols):
    """The reference's eval_lowered key building: every row rendered."""
    rendered = [[ref_low._key_str(v) for v in df[c]] for c in cols]
    keys = list(zip(*rendered)) if rendered else [()] * len(df)
    uniq = sorted(set(keys))
    sid_of = {k: i for i, k in enumerate(uniq)}
    return uniq, np.asarray([sid_of[k] for k in keys], dtype=np.int64)


@pytest.mark.parametrize("kind", ["strings", "arrow", "mixed", "no-tags"])
def test_series_keys_render_as_reference(kind):
    """The port's vectorised key rendering gives the reference's series
    keys and order: NULL, NaN and "" tag values all render as "" (and
    merge), numbers render as their str."""
    rng = np.random.default_rng(9)
    n = 500
    a = rng.choice(np.array(["x", "", None, "y"], dtype=object), n)
    b = rng.choice(np.array(["dc0", "dc1", np.nan], dtype=object), n)
    if kind == "arrow":
        a = pd.array(a, dtype="string[pyarrow]")
    cols = {"__g_a": a, "__g_b": b}
    if kind == "mixed":
        cols["__g_c"] = rng.choice(np.array([1, 2.5, None, "2.5"],
                                            dtype=object), n)
    df = pd.DataFrame(cols if kind != "no-tags" else {"v": np.zeros(n)})
    keys = [c for c in df.columns if c.startswith("__g_")]
    want = _reference_keys(df, keys)
    uniq, sids = lowering._series_keys(df, keys)
    assert uniq == want[0]
    np.testing.assert_array_equal(sids, want[1])


# ---------------------------------------------------------------------------
# the region-backed select
# ---------------------------------------------------------------------------

def _select(fe, side, text):
    parse = ref_parse_promql if side == "ref" else parse_promql
    sel = parse(text)
    return fe.promql_engine().select(sel, SPAN[0] - 60_000, SPAN[1],
                                     _ctx(side))


def _assert_same_selection(want, got, what):
    assert got.labels == want.labels, what
    assert (got.data_min, got.data_max) == (want.data_min, want.data_max)
    if want.matrix is None:
        assert got.matrix is None, what
        return
    for name in ("ts", "values", "lengths"):
        np.testing.assert_array_equal(getattr(got.matrix, name),
                                      getattr(want.matrix, name),
                                      err_msg=f"{what}: {name}")


def _counter(name):
    return telemetry.registry().get_sample_value(
        f"greptime_{name}_total") or 0.0


@pytest.mark.parametrize("text", SELECTORS)
def test_select_cold_matches_reference(fes, text):
    _clear_caches()
    n0 = _counter("promql_select_resident")
    want = _select(fes["ref"], "ref", text)
    got = _select(fes["port"], "port", text)
    assert want.labels, text
    _assert_same_selection(want, got, text)
    assert _counter("promql_select_resident") > n0


@pytest.fixture()
def streamed(fes):
    """SET stream_threshold_rows = 1 in both packages, restored after."""
    saved = ref_stream.stream_threshold_rows(), \
        stream_exec.stream_threshold_rows()
    for side in SIDES:
        fes[side].do_query("SET stream_threshold_rows = 1", _ctx(side))
    _clear_caches()
    yield
    ref_stream.configure_streaming(threshold_rows=saved[0])
    stream_exec.configure_streaming(threshold_rows=saved[1])


@pytest.mark.parametrize("text", SELECTORS)
def test_select_streamed_matches_reference(fes, streamed, text):
    n0 = _counter("promql_select_streamed")
    want = _select(fes["ref"], "ref", text)
    got = _select(fes["port"], "port", text)
    _assert_same_selection(want, got, text)
    assert _counter("promql_select_streamed") > n0
    assert not tpu_exec.SCAN_CACHE._entries   # the cold read stays cold


def test_select_through_sst_index_matches_reference(fes, streamed):
    """An equality matcher on the cold read resolves to the SST index's
    candidate series (matcher_sids), and the merged read keeps only
    their rows; the answer equals the reference's and the index-off
    read's (tests/test_sst_index.py's PromQL selector case)."""
    from greptimedb_tpu_torch.common import exec_stats
    text = "ctr{host='h2'}"
    (region,) = fes["port"].catalog.table("greptime", "public",
                                          "ctr").regions.values()
    sel = parse_promql(text)
    tags = region.series_dict.tag_names
    eq = [m for m in sel.matchers if m.op == "=" and m.name in tags]
    sids = lowering.matcher_sids(region, tags, eq)
    assert sids is not None and len(sids) == 1
    want = _select(fes["ref"], "ref", text)
    answers = {}
    try:
        for on in (1, 0):
            fes["port"].do_query(f"SET sst_index = {on}")
            with exec_stats.collect() as stats:
                answers[on] = _select(fes["port"], "port", text)
            rows = {k: st.rows for k, st in stats.stages.items()}
            full = region.snapshot().read_merged().num_rows
            if on:
                assert 0 < rows["promql_cold_scan"] < full, rows
    finally:
        fes["port"].do_query("SET sst_index = 1")
    _assert_same_selection(want, answers[1], text)
    _assert_same_selection(want, answers[0], text + " (index off)")


def test_tql_eval_over_the_streamed_read(fes, streamed, floor):
    floor(10 ** 9)
    for q in ("ctr{host='h2'}", "sum by (dc) (rate(ctr[1m]))"):
        assert _tql(fes["port"], "port", q) == _tql(fes["ref"], "ref", q)


# ---------------------------------------------------------------------------
# the reset_corr moment
# ---------------------------------------------------------------------------

def _schema(side):
    if side == "ref":
        from greptimedb_tpu.datatypes import data_type as dt
        from greptimedb_tpu.datatypes.schema import (ColumnSchema, Schema,
                                                     SemanticType)
    else:
        from greptimedb_tpu_torch.datatypes import data_type as dt
        from greptimedb_tpu_torch.datatypes.schema import (
            ColumnSchema, Schema, SemanticType)
    return Schema([
        ColumnSchema("host", dt.STRING, semantic_type=SemanticType.TAG),
        ColumnSchema("ts", dt.TIMESTAMP_MILLISECOND, nullable=False,
                     semantic_type=SemanticType.TIMESTAMP),
        ColumnSchema("v", dt.FLOAT64, semantic_type=SemanticType.FIELD)])


def _rate_plan(side, group_tags=("host",), stride=None):
    """The lowering's rate plan: count, first, last, min_ts, max_ts and
    reset_corr of v per (host [, bucket])."""
    mod = ref_ir if side == "ref" else ir
    BG = (ref_exec if side == "ref" else tpu_exec).BucketGroup
    return mod.plan_from_specs(
        _schema(side),
        [("__n", "count", "v"), ("__first", "first", "v"),
         ("__last", "last", "v")],
        group_tags=list(group_tags),
        bucket=BG(stride, 1, "__promql_window") if stride else None,
        moment_specs=[("__mnt", "min_ts", "v"), ("__mxt", "max_ts", "v"),
                      ("__corr", "reset_corr", "v")])


def _counter_rows(seed, hosts=7, n=60):
    """Sorted (series, ts) rows of counters with resets, NULL samples,
    and hosts of one sample."""
    rng = np.random.default_rng(seed)
    sids, ts, vals, valid = [], [], [], []
    for h in range(hosts):
        k = 1 if h in (2, 5) else n
        t = np.sort(rng.choice(np.arange(0, 10 * n), k, replace=False))
        v = np.cumsum(rng.integers(0, 6, k)).astype(np.float64)
        for r in rng.integers(1, max(k, 2), 3 if k > 1 else 0):
            v[r:] -= v[r] - rng.integers(0, 3)
        sids.append(np.full(k, h, np.int32))
        ts.append(t * 1000)
        vals.append(v)
        valid.append(rng.random(k) > 0.1)
    return (np.concatenate(sids), np.concatenate(ts).astype(np.int64),
            np.concatenate(vals), np.concatenate(valid))


def _scan_data(side, sids, ts, vals, valid, hosts=7):
    sd = (RefSeriesDict if side == "ref" else SeriesDict)(["host"])
    sd.encode_rows([[f"h{h}" for h in range(hosts)]])
    data = types.SimpleNamespace(series_ids=sids, ts=ts,
                                 fields={"v": (vals, valid)})
    return data, sd


def _partial(side, plan, rows):
    mod = ref_stream if side == "ref" else stream_exec
    data, sd = _scan_data(side, *rows)
    return mod._host_partial_frame(data, None, plan, sd)


@pytest.mark.parametrize("stride", [None, 7_000, 1_000],
                         ids=["per-series", "buckets", "one-row-buckets"])
def test_host_partial_frame_reset_corr_matches_reference(stride):
    rows = _counter_rows(3)
    want = _partial("ref", _rate_plan("ref", stride=stride), rows)
    got = _partial("port", _rate_plan("port", stride=stride), rows)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    (corr,) = [m.slot for m in _rate_plan("port").moments
               if m.op == "reset_corr"]
    # one-row runs have no pair to reset; longer runs do
    assert (want[corr] > 0).any() == (stride != 1_000)


def _sliced(side, plan, rows, edges):
    """Partial frames of `rows` cut into time slices at `edges` (as the
    streamed path reads them), concatenated."""
    sids, ts = rows[:2]
    frames = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        keep = (ts >= lo) & (ts < hi)
        order = np.lexsort((ts[keep], sids[keep]))
        part = tuple(a[keep][order] for a in rows)
        f = _partial(side, plan, part)
        if f is not None:
            frames.append(f)
    return pd.concat(frames[::-1], ignore_index=True)


@pytest.mark.parametrize("branch", ["per-group", "vectorised"])
def test_finalize_folds_reset_corr_across_slices(branch):
    """Slice partials fold to the whole run's correction, with the reset
    that falls on a slice edge counted by the boundary term; both of
    `_finalize`'s branches (one group: the per-group merge; several
    groups with a partial per slice: the vectorised fold) equal the
    reference's exactly."""
    rows = _counter_rows(5)
    if branch == "per-group":
        keep = rows[0] == 0
        rows = tuple(a[keep] for a in rows)
    sids, ts, vals, valid = rows
    # an edge exactly at a reset of host 0: the slice before it ends on
    # the pre-reset sample, the next starts on the post-reset one
    h0 = np.nonzero((sids == 0) & valid)[0]
    drops = [j for a, j in zip(h0[:-1], h0[1:]) if vals[j] < vals[a]]
    assert drops
    edges = [0, int(ts[drops[0]]), int(ts.max()) // 2 + 1,
             int(ts.max()) + 1]
    groups = () if branch == "per-group" else ("host",)
    out = {}
    for side in SIDES:
        plan = _rate_plan(side, group_tags=groups)
        whole = _partial(side, plan, rows)
        sliced = _sliced(side, plan, rows, edges)
        fin = (ref_exec if side == "ref" else tpu_exec)._finalize
        out[side] = (fin(whole, plan), fin(sliced, plan))
    pd.testing.assert_frame_equal(out["port"][1], out["ref"][1],
                                  check_exact=True)
    srt = [f.sort_values(list(f.columns[:len(groups)]) or ["__corr"])
           .reset_index(drop=True) for f in out["port"]]
    pd.testing.assert_frame_equal(srt[1], srt[0], check_exact=True)
    # without the boundary term the fold would miss the edge's reset
    assert (out["port"][1]["__corr"] > 0).any()


def test_plan_codec_round_trips_reset_corr():
    d = plan_codec.plan_to_dict(_rate_plan("port", stride=60_000))
    assert d == ref_codec.plan_to_dict(_rate_plan("ref", stride=60_000))
    assert "reset_corr" in plan_codec.KNOWN_MOMENT_OPS
    back = plan_codec.plan_from_dict(d)
    assert plan_codec.plan_to_dict(back) == d
    assert tpu_exec.plan_needs_host(back)


# ---------------------------------------------------------------------------
# TQL EXPLAIN / ANALYZE
# ---------------------------------------------------------------------------

EXPLAINED = ["sum by (host) (rate(ctr[1m]))", "avg(ctr)",
             "topk(1, ctr)", "max by (host) (max_over_time(ctr{dc='dc0'}"
             "[1m]))", "sum (rate(ctr{host='h2'}[1m]))",
             "sum by (dc) (increase(ctr[1m] offset 30s)) / 2"]


@pytest.mark.parametrize("rows", [0, 10 ** 9], ids=["lowered", "row-path"])
@pytest.mark.parametrize("q", EXPLAINED)
def test_tql_explain_matches_reference(fes, floor, q, rows):
    floor(rows)
    got = _tql(fes["port"], "port", q, verb="EXPLAIN")
    assert got == _tql(fes["ref"], "ref", q, verb="EXPLAIN")
    route = "TpuAggregateExec" if rows == 0 and "topk" not in q \
        else "promql-row-path"
    assert route in got


def _masked(text):
    return re.sub(r"elapsed: [0-9.e+-]+ms", "elapsed: <ms>", text)


@pytest.mark.parametrize("rows", [0, 10 ** 9], ids=["lowered", "row-path"])
def test_tql_analyze_matches_reference(fes, floor, rows):
    floor(rows)
    q = "sum by (dc) (rate(ctr[1m]))"
    out = {}
    for side in SIDES:
        (res,) = fes[side].do_query(
            f"TQL ANALYZE (0, 790, '60s') {q}", _ctx(side))
        plan = {}
        for b in res.batches:
            d = b.to_pydict()
            plan.update(zip(d["plan_type"], d["plan"]))
        out[side] = plan
    assert list(out["port"]) == ["logical_plan", "analyze"]
    assert out["port"]["logical_plan"] == out["ref"]["logical_plan"]
    assert _masked(out["port"]["analyze"]) == _masked(out["ref"]["analyze"])
    stages = [ln.split(":")[0] for ln in
              out["port"]["analyze"].splitlines()[1:]]
    assert "dispatch" in stages
